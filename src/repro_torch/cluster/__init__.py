"""Stateful, vectorized cluster control loop (EcoShift §5.4, multi-round).

 * ``budget``     — budget/price/carbon providers and the per-domain cap
                    override book;
 * ``scenario``   — declarative event timelines, with an optional power
                    topology and its domain cap changes;
 * ``predictor``  — round telemetry and the online NCF predictor;
 * ``controller`` — stateful controllers carrying warm option tables;
 * ``sim``        — the time-stepped multi-round engine.
"""

from repro_torch.core.topology import PowerDomain, PowerTopology  # noqa: F401
from repro_torch.cluster.budget import (  # noqa: F401
    BudgetProvider,
    ConstantProvider,
    OverrideBook,
    TraceReplayProvider,
    as_provider,
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
    make_controller,
)
