"""Declarative scenario timelines for multi-round cluster simulation.

A ``Scenario`` describes what happens when: the reclaimed budget (and
optional price / CO2-intensity signals) per round and the cluster events —
node failures, arrivals, straggler onsets, workload phase changes and
power-domain cap changes.  Signals are provider-backed
(``repro_torch.cluster.budget``); a raw trace (scalar, per-round sequence
holding its last value, or callable) is wrapped into a
``TraceReplayProvider``.  A budget of ``None`` means "derive the pool from
donor headroom this round".

A scenario may attach a power topology (``with_topology``): the rack/PDU
domain tree the engine enforces.  Attachment makes node-id events fail
fast — ``with_failure`` / ``with_straggler`` / ``with_phase_change``
referencing node ids no leaf domain owns raise at build time instead of
mid-sim — and enables ``DomainCapChange`` events (e.g. a rack PDU
derating mid-scenario).  The engine applies a round's events, cap changes
included, before it resolves that round's budget and domain headroom.

Fault events (``repro_torch.cluster.faults``) attach on a channel of their
own (``with_faults``, ``with_fault_storm``), and the engine resolves them
per round.  ``carbon_aware`` and ``price_capped`` build the day-scale
scenarios the receding-horizon planner rides.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence, Union

from repro_torch.cluster import budget as budget_mod
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import AppSpec


@dataclasses.dataclass(frozen=True)
class NodeFailure:
    """Nodes die at the start of ``round``; their cap allotment returns to
    the reclaimed pool and the controller re-optimizes over survivors."""

    round: int
    node_ids: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StragglerOnset:
    """A node's true surface slows by ``slowdown`` from ``round`` on."""

    round: int
    node_id: int
    slowdown: float


@dataclasses.dataclass(frozen=True)
class PhaseChange:
    """A node's workload enters a new phase: its surface rebinds to
    ``surface_id`` (must exist in the simulation's surface table)."""

    round: int
    node_id: int
    surface_id: str


@dataclasses.dataclass(frozen=True)
class NodeArrival:
    """A new instance of ``app`` joins at ``round`` (caps default to the
    system's initial uniform caps); ``surface`` optionally registers a
    ground-truth surface for an app the simulation has never seen."""

    round: int
    app: AppSpec
    caps: tuple[float, float] | None = None
    surface: PowerSurface | None = None
    #: leaf power-domain placement (required by topology-constrained sims
    #: when the assigned node id falls outside every leaf's range)
    domain: str | None = None


@dataclasses.dataclass(frozen=True)
class DomainCapChange:
    """A power domain's cap moves to ``cap`` watts from ``round`` on — a
    rack PDU derating, a site-level demand-response curtailment.  Applies
    to any domain (leaf or internal) of the simulation's topology."""

    round: int
    domain: str
    cap: float


Event = Union[
    NodeFailure, StragglerOnset, PhaseChange, NodeArrival, DomainCapChange
]


def _validate_against_topology(events: Sequence[Event], topology) -> None:
    """Build-time fail-fast: every node-id event must reference ids some
    leaf domain owns, and domain events must name existing domains (one
    vectorized ``leaf_of`` per node-id event)."""
    for e in events:
        if isinstance(e, (NodeFailure, StragglerOnset, PhaseChange)):
            ids = list(e.node_ids) if isinstance(e, NodeFailure) else [e.node_id]
            try:
                topology.leaf_of(ids)
            except ValueError as err:
                raise ValueError(
                    f"{type(e).__name__} at round {e.round}: {err}"
                ) from None
        elif isinstance(e, NodeArrival):
            if e.domain is not None:
                try:
                    topology.require_leaf(e.domain)
                except ValueError as err:
                    raise ValueError(f"arrival at round {e.round}: {err}") from None
        elif isinstance(e, DomainCapChange):
            if e.domain not in topology.index:
                raise ValueError(
                    f"cap change at round {e.round} references unknown "
                    f"domain {e.domain!r}"
                )
            if e.cap <= 0:
                raise ValueError(
                    f"cap change at round {e.round}: cap must be positive"
                )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A timeline of ``n_rounds`` redistribution rounds."""

    n_rounds: int
    #: reclaimed budget per round (None = donor-derived pool)
    budget: object = None
    #: optional power price per round, recorded alongside results
    power_price: object = None
    events: tuple[Event, ...] = ()
    #: optional power-domain tree (repro_torch.core.topology.PowerTopology);
    #: the engine adopts and enforces it, and the builders validate node-id
    #: events against its leaf ranges at build time
    topology: object | None = None
    #: optional grid CO2-intensity signal, recorded alongside results and
    #: the receding-horizon planner's preferred weight feed
    carbon: object = None
    #: fault-injection events (repro_torch.cluster.faults) the engine
    #: resolves per round
    faults: tuple = ()

    def __post_init__(self):
        for field in ("budget", "power_price", "carbon"):
            v = getattr(self, field)
            p = budget_mod.as_provider(v)
            if p is not v:
                object.__setattr__(self, field, p)

    def budget_at(self, r: int) -> float | None:
        """Cluster budget at round ``r`` (None = donor-derived pool)."""
        return None if self.budget is None else self.budget.budget_at(r)

    def price_at(self, r: int) -> float | None:
        return None if self.power_price is None else self.power_price.budget_at(r)

    def carbon_at(self, r: int) -> float | None:
        return None if self.carbon is None else self.carbon.budget_at(r)

    def budget_forecast(self, r: int, horizon: int) -> tuple:
        """Budgets for rounds ``r .. r+horizon-1`` (None entries where
        unset) — what the receding-horizon controller plans over."""
        if self.budget is None:
            return (None,) * int(horizon)
        return tuple(self.budget.forecast(r, horizon))

    def price_forecast(self, r: int, horizon: int) -> tuple:
        if self.power_price is None:
            return (None,) * int(horizon)
        return tuple(self.power_price.forecast(r, horizon))

    def carbon_forecast(self, r: int, horizon: int) -> tuple:
        if self.carbon is None:
            return (None,) * int(horizon)
        return tuple(self.carbon.forecast(r, horizon))

    def events_at(self, r: int) -> tuple[Event, ...]:
        idx = self.__dict__.get("_events_by_round")
        if idx is None:
            idx = {}
            for e in self.events:
                idx.setdefault(e.round, []).append(e)
            idx = {k: tuple(v) for k, v in idx.items()}
            object.__setattr__(self, "_events_by_round", idx)
        return idx.get(r, ())

    # -- builders ------------------------------------------------------------

    @staticmethod
    def constant(n_rounds: int, budget: float | None = None) -> "Scenario":
        return Scenario(n_rounds=n_rounds, budget=budget)

    def with_events(self, events: Sequence[Event]) -> "Scenario":
        """Attach events (one replace, one validation sweep against the
        attached topology, if any)."""
        for e in events:
            if not 0 <= e.round < self.n_rounds:
                raise ValueError(
                    f"event round {e.round} outside [0, {self.n_rounds})"
                )
        if self.topology is not None:
            _validate_against_topology(events, self.topology)
        return dataclasses.replace(self, events=self.events + tuple(events))

    def with_event(self, event: Event) -> "Scenario":
        return self.with_events((event,))

    def with_failure(self, round: int, *node_ids: int) -> "Scenario":
        return self.with_event(NodeFailure(round=round, node_ids=tuple(node_ids)))

    def with_straggler(
        self, round: int, node_id: int, slowdown: float
    ) -> "Scenario":
        return self.with_event(
            StragglerOnset(round=round, node_id=node_id, slowdown=slowdown)
        )

    def with_phase_change(
        self, round: int, node_id: int, surface_id: str
    ) -> "Scenario":
        return self.with_event(
            PhaseChange(round=round, node_id=node_id, surface_id=surface_id)
        )

    def with_arrival(
        self,
        round: int,
        app: AppSpec,
        caps: tuple[float, float] | None = None,
        surface: PowerSurface | None = None,
        domain: str | None = None,
    ) -> "Scenario":
        return self.with_event(
            NodeArrival(
                round=round, app=app, caps=caps, surface=surface, domain=domain
            )
        )

    def with_topology(self, topology) -> "Scenario":
        """Attach the power-domain tree: existing events are validated
        against its leaf ranges in one sweep, and every later builder call
        validates what it adds."""
        _validate_against_topology(self.events, topology)
        return dataclasses.replace(self, topology=topology)

    def with_domain_cap(self, round: int, domain: str, cap: float) -> "Scenario":
        """A rack/PDU derating (or uprating): ``domain``'s cap becomes
        ``cap`` watts from ``round`` on."""
        return self.with_event(DomainCapChange(round=round, domain=domain, cap=cap))

    def with_faults(self, faults: Sequence) -> "Scenario":
        """Attach fault-injection events (``repro_torch.cluster.faults``):
        telemetry drops/delays/corruption/stale repeats, actuation
        NACK/partial/delayed application, controller crashes.  Validated
        at build time; the engine resolves them per round."""
        from repro_torch.cluster import faults as faults_mod

        faults = tuple(faults)
        faults_mod.validate_faults(faults, self.n_rounds)
        return dataclasses.replace(self, faults=self.faults + faults)

    def with_fault_storm(self, seed: int = 0, **rates) -> "Scenario":
        """Attach a seeded randomized fault storm (see
        :func:`repro_torch.cluster.faults.fault_storm` for the rates)."""
        from repro_torch.cluster import faults as faults_mod

        return self.with_faults(
            faults_mod.fault_storm(self.n_rounds, seed, **rates)
        )

    def with_budget_provider(self, provider) -> "Scenario":
        """Attach a budget source: any ``BudgetProvider`` or a raw trace
        (wrapped via ``budget.as_provider``)."""
        return dataclasses.replace(
            self, budget=budget_mod.as_provider(provider)
        )

    def with_budget(self, budget) -> "Scenario":
        """Deprecated raw-trace budget attachment: an alias of
        :meth:`with_budget_provider` that warns."""
        warnings.warn(
            "Scenario.with_budget(trace) is deprecated; use "
            "Scenario.with_budget_provider(...) (raw traces are "
            "auto-wrapped into a TraceReplayProvider)",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.with_budget_provider(budget)

    def with_power_price(self, provider) -> "Scenario":
        """Attach a price signal: recorded per round, and the horizon
        planner's weight feed when no carbon signal is attached."""
        return dataclasses.replace(
            self, power_price=budget_mod.as_provider(provider)
        )

    def with_carbon(self, provider) -> "Scenario":
        """Attach a grid CO2-intensity signal (provider or raw trace): the
        receding-horizon planner weights its spend plan by it."""
        return dataclasses.replace(
            self, carbon=budget_mod.as_provider(provider)
        )

    @staticmethod
    def carbon_aware(
        n_rounds: int,
        budget,
        carbon=None,
        power_price=None,
    ) -> "Scenario":
        """Day-scale carbon-aware scenario: a budget provider plus CO2 and
        price signals (defaults: the shipped ``co2_day`` / ``price_day``
        fixtures resampled to ``n_rounds``)."""
        return Scenario(
            n_rounds=n_rounds,
            budget=budget_mod.as_provider(budget),
            carbon=budget_mod.as_provider(
                carbon
                if carbon is not None
                else budget_mod.fixture_trace("co2_day", n_rounds)
            ),
            power_price=budget_mod.as_provider(
                power_price
                if power_price is not None
                else budget_mod.fixture_trace("price_day", n_rounds)
            ),
        )

    @staticmethod
    def price_capped(
        n_rounds: int,
        pool_watts: float,
        prices: Sequence[float],
        spend_cap: float,
    ) -> "Scenario":
        """Budget follows a power-price trace: each round distributes
        ``min(pool, spend_cap / price)`` watts."""
        budgets = [
            min(pool_watts, spend_cap / max(float(p), 1e-12)) for p in prices
        ]
        return Scenario(
            n_rounds=n_rounds, budget=tuple(budgets), power_price=tuple(prices)
        )
