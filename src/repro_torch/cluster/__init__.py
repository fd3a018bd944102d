"""Stateful, vectorized cluster control loop (EcoShift §5.4, multi-round).

 * ``budget``     — budget/price/carbon providers (constant, trace replay,
                    scaled/min composition, step overrides), the
                    per-domain cap override book and the shipped day-scale
                    CO2/price/solar fixtures;
 * ``scenario``   — declarative event timelines, with an optional power
                    topology and its domain cap changes;
 * ``faults``     — seeded fault injection (telemetry drops / corruption,
                    actuation NACK/partial/delay, controller crash and
                    restore) resolved by the engine's PowerGuard watchdog
                    and the controllers' pins and snapshots;
 * ``predictor``  — round telemetry and the online NCF predictor;
 * ``controller`` — stateful controllers carrying warm option tables;
 * ``sim``        — the time-stepped multi-round engine.
"""

from repro_torch.core.topology import PowerDomain, PowerTopology  # noqa: F401
from repro_torch.cluster.budget import (  # noqa: F401
    BudgetProvider,
    ConstantProvider,
    MinProvider,
    OverrideBook,
    ScaledProvider,
    StepOverrideProvider,
    TraceReplayProvider,
    as_provider,
    fixture_provider,
    fixture_trace,
    load_fixture,
    solar_budget,
)
from repro_torch.cluster.scenario import (  # noqa: F401
    DomainCapChange,
    NodeArrival,
    NodeFailure,
    PhaseChange,
    Scenario,
    StragglerOnset,
)
from repro_torch.cluster.predictor import (  # noqa: F401
    OnlinePredictor,
    OnlinePredictorConfig,
    TelemetryBatch,
    TelemetryRecord,
)
from repro_torch.cluster.faults import (  # noqa: F401
    ActuationDelay,
    ActuationNack,
    ActuationPartial,
    ActuationReport,
    ControllerCrash,
    FaultInjector,
    TelemetryCorrupt,
    TelemetryDelay,
    TelemetryDrop,
    TelemetryStale,
    fault_storm,
    validate_faults,
)
from repro_torch.cluster.sim import (  # noqa: F401
    ClusterSim,
    NodeState,
    NodeTable,
    RoundRecord,
    SimResult,
)
from repro_torch.cluster.controller import (  # noqa: F401
    Controller,
    ControllerConfig,
    load_snapshot,
    make_controller,
    save_snapshot,
)
