"""Declarative scenario timelines for multi-round cluster simulation.

A ``Scenario`` describes what happens when: the reclaimed budget (and
optional price / CO2-intensity signals) per round and the cluster events —
node failures, arrivals, straggler onsets, workload phase changes.
Signals are provider-backed (``repro_torch.cluster.budget``); a raw trace
(scalar, per-round sequence holding its last value, or callable) is
wrapped into a ``TraceReplayProvider``.  A budget of ``None`` means
"derive the pool from donor headroom this round".

Power topologies, domain cap changes and fault injection are not ported
yet: their builders raise (ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

from repro_torch.cluster import budget as budget_mod
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import AppSpec

TOPOLOGY_NOT_PORTED = (
    "power topologies, domain caps and fault injection are not ported "
    "yet: ROADMAP.md, queue 1, item 5"
)


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


Event = Union[NodeFailure, StragglerOnset, PhaseChange, NodeArrival]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A timeline of ``n_rounds`` redistribution rounds."""

    n_rounds: int
    #: reclaimed budget per round (None = donor-derived pool)
    budget: object = None
    #: optional power price per round, recorded alongside results
    power_price: object = None
    events: tuple[Event, ...] = ()
    #: optional grid CO2-intensity signal, recorded alongside results
    carbon: object = None

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
        for e in events:
            if not 0 <= e.round < self.n_rounds:
                raise ValueError(
                    f"event round {e.round} outside [0, {self.n_rounds})"
                )
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
    ) -> "Scenario":
        return self.with_event(
            NodeArrival(round=round, app=app, caps=caps, surface=surface)
        )

    def with_topology(self, topology) -> "Scenario":
        raise NotImplementedError(TOPOLOGY_NOT_PORTED)

    def with_domain_cap(self, round: int, domain: str, cap: float) -> "Scenario":
        raise NotImplementedError(TOPOLOGY_NOT_PORTED)

    def with_faults(self, faults) -> "Scenario":
        raise NotImplementedError(TOPOLOGY_NOT_PORTED)

    def with_fault_storm(self, seed: int = 0, **rates) -> "Scenario":
        raise NotImplementedError(TOPOLOGY_NOT_PORTED)
