"""Time-stepped multi-round cluster simulation engine (paper §5.4, temporal).

``ClusterSim`` owns the cluster state and steps a :class:`Scenario` against
a stateful :class:`~repro_torch.cluster.controller.Controller`:

 1. apply this round's events (failures, stragglers, arrivals, phase
    changes) and invalidate the controller's per-receiver warm state;
 2. partition donors/receivers, derive (or read) the reclaimed budget;
 3. the controller allocates (a controller that serves its own surfaces,
    ``ecoshift_online``, gets batches with no surface filled in: ground
    truth never reaches it);
 4. the engine measures true improvements, emits them as a
    :class:`~repro_torch.cluster.predictor.TelemetryBatch` and feeds them
    back through ``Controller.ingest_telemetry``.

State is columnar (:class:`NodeTable`), and measurement is vectorized with
the same RNG stream as ``repro.cluster.sim``, so every record is bitwise
the reference's.  The engine itself is numpy on the host; the controller's
solver runs on the sim's ``device`` (None = the CUDA card).

The table logs the rows each mutation dirties (``NodeTable.bump`` /
``dirty_since``), and the engine hands grouped controllers copy-on-write
receiver batches under the reference's delta contract (``seq``,
``prev_seq``, ``delta``, ``removed``): an event-free round gets the
previous batch object back, and a round whose dirty rows the log bounds
gets a patched batch naming the changed positions.  That is what the
incremental controller's grouping and allocation cache key on.

A sim may carry a power-domain tree (``topology=``, or a scenario's
``with_topology``): every node interns its owning leaf, the round hands
hierarchical controllers (``supports_hierarchical``) each domain's
extra-power headroom (cap, with ``DomainCapChange`` overrides, net of the
committed draw), and after every allocation the engine records each
domain's draw and cap (``RoundRecord.domain_draw`` / ``domain_caps``) and,
for hierarchical controllers, raises on any domain driven past its cap.

A scenario's fault events (``Scenario.with_faults``) run through a
per-run :class:`~repro_torch.cluster.faults.FaultInjector`: a controller
crash (and restore) at round start, actuation faults replayed through the
per-receiver actuator registers after the allocation, then the PowerGuard
watchdog, which derates the applied caps back under every domain cap and
the round budget in the same round (``RoundRecord.overdraw_w`` /
``derate_w`` / ``excursion_domains`` / ``nacked``), and the telemetry
channel's drops, delays, stale repeats and corruption on the way back
(``telemetry_faults``).  A controller with ``horizon > 1`` gets the
scenario's budget forecast and its CO2 (else price) weights every round
(``set_budget_outlook``).

The device-resident ``DeviceView`` of the node columns is not ported
(ROADMAP.md, queue 1, item 2.3).  The reference's natural-draw and
baseline-runtime caches are left out: they speed up the host side and
never change a result.
"""

from __future__ import annotations

import dataclasses
import itertools
import time as _time
import zlib
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.cluster import budget as budget_mod
from repro_torch.cluster import scenario as scenario_mod
from repro_torch.cluster.predictor import TelemetryBatch
from repro_torch.cluster.scenario import Scenario
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import (
    AppSpec,
    EmulationResult,
    ReceiverBatch,
    SystemSpec,
)
from repro_torch.device import resolve_device

#: per-round offset into the measurement RNG stream (round 0 == the legacy
#: single-round stream)
_ROUND_STRIDE = 1000003

#: process-global batch sequence numbers
_BATCH_SEQ = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class NodeState:
    node_id: int
    app: AppSpec  # instance (name is unique per node)
    base_app: str  # underlying app name (surface / predictor identity)
    caps: tuple[float, float]
    alive: bool = True
    slowdown: float = 1.0  # straggler factor on the true surface


@dataclasses.dataclass(frozen=True)
class _SlowedSurface(PowerSurface):
    base: PowerSurface
    slowdown: float

    def runtime(self, c, g):
        return self.base.runtime(c, g) * self.slowdown

    def power_draw(self, c, g):
        return self.base.power_draw(c, g)

    def improvement(self, base, c, g):
        # relative improvement is exactly invariant under a constant
        # slowdown: delegate so a straggler's option table digests
        # bit-identical to its healthy peers'
        return self.base.improvement(base, c, g)


# ---------------------------------------------------------------------------
# Columnar node state
# ---------------------------------------------------------------------------


class _Interner:
    """Append-only string -> small-int table shared by a NodeTable."""

    __slots__ = ("strings", "_ids")

    def __init__(self):
        self.strings: list[str] = []
        self._ids: dict[str, int] = {}

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self.strings)
            self.strings.append(s)
            self._ids[s] = i
        return i

    def __getitem__(self, i: int) -> str:
        return self.strings[i]


#: dirty-row log horizon: consumers lagging more than this many bumps
#: behind fall back to a full rebuild
_DIRTY_HORIZON = 64


class NodeTable:
    """Struct-of-arrays cluster node state.

    Columns: ``caps [n,2]``, ``alive [n]``, ``slowdown [n]``,
    ``node_ids [n]`` plus interned-id columns ``base_gid`` (true-surface /
    base-app name), ``sid_gid`` (the instance AppSpec's surface id),
    ``name_gid`` (instance name) and ``sclass_gid``, all indexing the shared
    :class:`_Interner`, and ``domain_id`` (-1: no topology).  Rows are
    append-only (failures flip ``alive``).

    **Delta tracking**: every mutation through the engine bumps ``version``
    and logs the rows it touched; consumers remember the version they last
    materialized against and ask :meth:`dirty_since` for exactly the rows
    that moved.  A coarse ``bump()`` (no rows) marks everything dirty.
    """

    def __init__(self):
        self.interner = _Interner()
        self.node_ids = np.empty(0, dtype=np.int64)
        self.caps = np.empty((0, 2), dtype=np.float64)
        self.alive = np.empty(0, dtype=bool)
        self.slowdown = np.empty(0, dtype=np.float64)
        self.base_gid = np.empty(0, dtype=np.int32)
        self.sid_gid = np.empty(0, dtype=np.int32)
        self.name_gid = np.empty(0, dtype=np.int32)
        self.sclass_gid = np.empty(0, dtype=np.int32)
        self.domain_id = np.empty(0, dtype=np.int32)
        self.names: list[str] = []
        self.version = 0
        #: (version, dirty row array | None-for-everything) ring
        self._dirty_log: list[tuple[int, np.ndarray | None]] = []

    def __len__(self) -> int:
        return len(self.node_ids)

    @property
    def strings(self) -> list[str]:
        return self.interner.strings

    def bump(self, rows: Sequence[int] | np.ndarray | None = None) -> None:
        """Advance ``version``; ``rows`` are the row indices this mutation
        touched (``None`` marks the whole table dirty)."""
        self.version += 1
        if rows is not None:
            rows = np.asarray(rows, dtype=np.int64)
        self._dirty_log.append((self.version, rows))
        if len(self._dirty_log) > _DIRTY_HORIZON:
            del self._dirty_log[: len(self._dirty_log) - _DIRTY_HORIZON]

    def dirty_since(self, version: int) -> np.ndarray | None:
        """Rows dirtied in ``(version, self.version]``, or None when the
        log can't prove a bound (horizon exceeded, unbounded bump, or a
        ``version`` this table never issued)."""
        if version == self.version:
            return np.empty(0, dtype=np.int64)
        if version > self.version:
            return None
        log = self._dirty_log
        if not log or log[0][0] > version + 1:
            return None
        parts = []
        for v, rows in log:
            if v <= version:
                continue
            if rows is None:
                return None
            parts.append(rows)
        if not parts:
            return None
        return np.unique(np.concatenate(parts))

    @staticmethod
    def from_nodes(nodes: Sequence[NodeState]) -> "NodeTable":
        t = NodeTable()
        if not nodes:
            return t
        t.node_ids = np.array([n.node_id for n in nodes], dtype=np.int64)
        t.caps = np.array([n.caps for n in nodes], dtype=np.float64)
        t.alive = np.array([n.alive for n in nodes], dtype=bool)
        t.slowdown = np.array([n.slowdown for n in nodes], dtype=np.float64)
        t.names = [n.app.name for n in nodes]
        t.base_gid = np.array(
            [t.interner.intern(n.base_app) for n in nodes], dtype=np.int32
        )
        t.sid_gid = np.array(
            [t.interner.intern(n.app.surface_id) for n in nodes], dtype=np.int32
        )
        t.name_gid = np.array(
            [t.interner.intern(n.app.name) for n in nodes], dtype=np.int32
        )
        t.sclass_gid = np.array(
            [t.interner.intern(n.app.sclass) for n in nodes], dtype=np.int32
        )
        t.domain_id = np.full(len(nodes), -1, dtype=np.int32)
        return t

    def append(
        self,
        *,
        node_id: int,
        name: str,
        base_app: str,
        surface_id: str,
        sclass: str,
        caps: tuple[float, float],
        domain_id: int = -1,
    ) -> None:
        self.node_ids = np.append(self.node_ids, np.int64(node_id))
        self.caps = np.concatenate(
            [self.caps, np.asarray([caps], dtype=np.float64)]
        )
        self.alive = np.append(self.alive, True)
        self.slowdown = np.append(self.slowdown, 1.0)
        self.names.append(name)
        self.base_gid = np.append(
            self.base_gid, np.int32(self.interner.intern(base_app))
        )
        self.sid_gid = np.append(
            self.sid_gid, np.int32(self.interner.intern(surface_id))
        )
        self.name_gid = np.append(
            self.name_gid, np.int32(self.interner.intern(name))
        )
        self.sclass_gid = np.append(
            self.sclass_gid, np.int32(self.interner.intern(sclass))
        )
        self.domain_id = np.append(self.domain_id, np.int32(domain_id))

    def next_node_id(self) -> int:
        return 1 + int(self.node_ids.max()) if len(self) else 0

    def rows_for_ids(self, ids: Sequence[int]) -> np.ndarray:
        row_of = {int(nid): r for r, nid in enumerate(self.node_ids)}
        return np.array([row_of[int(i)] for i in ids], dtype=np.int64)

    def view(self, row: int) -> NodeState:
        s = self.interner.strings
        return NodeState(
            node_id=int(self.node_ids[row]),
            app=AppSpec(
                name=self.names[row],
                sclass=s[self.sclass_gid[row]],
                surface_id=s[self.sid_gid[row]],
            ),
            base_app=s[self.base_gid[row]],
            caps=(float(self.caps[row, 0]), float(self.caps[row, 1])),
            alive=bool(self.alive[row]),
            slowdown=float(self.slowdown[row]),
        )

    def views(self, rows: Sequence[int] | None = None) -> list[NodeState]:
        if rows is None:
            rows = range(len(self))
        return [self.view(r) for r in rows]


def build_nodes(
    system: SystemSpec,
    apps: Sequence[AppSpec],
    *,
    n_nodes: int,
    seed: int,
    initial_caps: tuple[float, float] | None = None,
) -> list[NodeState]:
    """Place ``n_nodes`` instances by cycling a shuffled app list."""
    rng = np.random.default_rng(seed)
    order = list(apps)
    rng.shuffle(order)
    caps = initial_caps or (system.init_cpu, system.init_gpu)
    nodes = []
    for i in range(n_nodes):
        a = order[i % len(order)]
        inst = AppSpec(
            name=f"{a.name}#n{i}", sclass=a.sclass, surface_id=a.surface_id
        )
        nodes.append(NodeState(node_id=i, app=inst, base_app=a.name, caps=caps))
    return nodes


# ---------------------------------------------------------------------------
# Round records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundRecord:
    """Everything observed in one simulated round."""

    round: int
    result: EmulationResult
    pool: float  # donor-derived reclaimed pool this round
    n_alive: int
    events: tuple = ()
    power_price: float | None = None
    #: grid CO2 intensity this round (scenario carbon signal), if any
    carbon_intensity: float | None = None
    #: per-receiver noisy measurements (a TelemetryBatch)
    telemetry: object = ()
    #: host-clock seconds of the round's phases (partition_s, batch_s,
    #: allocate_s, conserve_s, measure_s); allocate_s ends after the
    #: solver's device -> host copy, so it covers the device work
    seconds: dict | None = None
    #: per-domain draw / cap watts this round (topology sims only); on a
    #: faulted round the draw is the settled (post-PowerGuard) one
    domain_draw: dict | None = None
    domain_caps: dict | None = None
    #: PowerGuard columns (fault-injected runs): worst pre-derate cap
    #: excursion in watts, total watts the emergency derate clawed back,
    #: and the domains that excursed this round ("__budget__" for the
    #: cluster budget)
    overdraw_w: float = 0.0
    derate_w: float = 0.0
    excursion_domains: tuple = ()
    #: receivers whose applied caps deviated from the command (NACK /
    #: partial / delayed actuation, or a PowerGuard derate)
    nacked: tuple = ()
    #: telemetry fault kinds applied to this round's batch
    telemetry_faults: tuple = ()

    @property
    def avg_improvement(self) -> float:
        return self.result.avg_improvement


@dataclasses.dataclass
class SimResult:
    """Trace of a whole scenario under one controller."""

    policy: str
    records: list[RoundRecord]

    @property
    def n_rounds(self) -> int:
        return len(self.records)

    @property
    def improvement_trace(self) -> np.ndarray:
        return np.array([r.avg_improvement for r in self.records])

    def improvements_of(self, name: str) -> np.ndarray:
        """Per-round improvement of one instance (NaN when not a receiver)."""
        return np.array(
            [r.result.improvements.get(name, np.nan) for r in self.records]
        )


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ClusterSim:
    """Columnar multi-round cluster engine.

    Constructed from a ``nodes`` list (ingested into a :class:`NodeTable`)
    or from an existing ``table``.  ``device`` is where controllers built
    by name solve (None = the CUDA card; raises when there is none).
    ``topology`` attaches a power-domain tree (:meth:`attach_topology`).
    """

    def __init__(
        self,
        system: SystemSpec,
        nodes: Sequence[NodeState] | None = None,
        surfaces: Mapping[str, PowerSurface] | None = None,
        n_repeats: int = 5,
        seed: int = 0,
        *,
        table: NodeTable | None = None,
        topology=None,
        device: str | torch.device | None = None,
    ):
        self.system = system
        self.device = resolve_device(device)
        #: true surfaces keyed by *base* app name
        self.surfaces: Mapping[str, PowerSurface] = surfaces or {}
        self.n_repeats = n_repeats
        self.seed = seed
        self.table = (
            table if table is not None else NodeTable.from_nodes(nodes or [])
        )
        #: memoized straggler views: stable object identity per (app,
        #: slowdown), so identity-keyed option caches stay warm
        self._slowed: dict = {}
        #: memoized partition per (table, version, natural draws): stable
        #: row-array objects double as identity tokens for the batch and
        #: measurement-group caches
        self._part_cache: tuple | None = None
        #: memoized (base surface, slowdown) grouping per (table, version,
        #: rows)
        self._measure_groups_cache: tuple | None = None
        #: receiver-batch cache: (table, mode, version, rows, batch)
        self._batch_cache: tuple | None = None
        #: telemetry emitted by the latest round
        self.last_telemetry: object = ()
        #: host-clock seconds of the latest round's phases
        self.last_round_seconds: dict[str, float] = {}
        #: hierarchical power-domain tree (core.topology.PowerTopology)
        self.topology = None
        #: DomainCapChange routing: per-domain (round, cap) steps, a step
        #: applying from its round on
        self._cap_overrides = budget_mod.OverrideBook()
        #: per-domain draw/cap observed by the latest topology round
        self.last_domain_draw: dict[str, float] | None = None
        self.last_domain_caps: dict[str, float] | None = None
        #: actuator registers (fault-injected runs), one row per table row:
        #: the (c, g) caps physically applied last round (``_reg_has``
        #: False = at the table baseline), and the command a one-round
        #: delayed application queued (``_pend_has``)
        self._reg_caps = np.zeros((0, 2))
        self._reg_has = np.zeros(0, dtype=bool)
        self._pend_caps = np.zeros((0, 2))
        self._pend_has = np.zeros(0, dtype=bool)
        #: ActuationReport / PowerGuard stats of the latest faulted round
        self.last_actuation: object | None = None
        self.last_guard: dict | None = None
        if topology is not None:
            self.attach_topology(topology)

    @staticmethod
    def build(
        system: SystemSpec,
        apps: Sequence[AppSpec],
        surfaces: Mapping[str, PowerSurface],
        *,
        n_nodes: int = 100,
        seed: int = 0,
        initial_caps: tuple[float, float] | None = None,
        topology=None,
        device: str | torch.device | None = None,
    ) -> "ClusterSim":
        nodes = build_nodes(
            system, apps, n_nodes=n_nodes, seed=seed, initial_caps=initial_caps
        )
        return ClusterSim(
            system=system,
            nodes=nodes,
            surfaces=surfaces,
            seed=seed,
            topology=topology,
            device=device,
        )

    # -- power-domain topology ------------------------------------------------

    def attach_topology(self, topology) -> None:
        """Adopt a power-domain tree: intern every node's owning leaf.

        Raises if any current node id sits outside every leaf range (the
        engine-side counterpart of the scenario's build-time check).
        Interning happens before any state changes, so a failed attach
        leaves the sim as it was.
        """
        t = self.table
        domain_id = topology.leaf_of(t.node_ids).astype(np.int32) if len(t) else None
        self.topology = topology
        self._cap_overrides = budget_mod.OverrideBook()
        if domain_id is not None:
            t.domain_id = domain_id
            t.bump()

    def _committed_draw(self, recv_rows: np.ndarray | None = None) -> np.ndarray:
        """[n] per-node committed watts: a receiver pins its baseline cap
        allotment, a donor its natural draw, a dead node nothing.

        ``recv_rows`` forces those rows to receiver accounting: a node the
        slack heuristic would call a donor but that a caller passes as a
        receiver is grown from its baseline, so it commits its caps.
        """
        t = self.table
        nat, donor = self._donor_mask()
        committed = np.where(donor, nat.sum(axis=1), t.caps.sum(axis=1))
        if recv_rows is not None and len(recv_rows):
            committed[recv_rows] = t.caps[recv_rows].sum(axis=1)
        committed[~t.alive] = 0.0
        return committed

    def domain_headroom(
        self,
        round_index: int = 0,
        recv_rows: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-domain ``(extra, committed, caps)`` at ``round_index``.

        ``caps`` resolves each domain's cap trace with the ``DomainCapChange``
        overrides active at that round; ``committed`` aggregates the
        per-node committed draw up the tree (``recv_rows`` as in
        :meth:`_committed_draw`); ``extra`` is the headroom the
        hierarchical allocator may spend inside each domain (>= 0).
        """
        topo = self.topology
        caps = topo.cap_at(round_index, self._cap_overrides.active(round_index))
        leaf = np.zeros(len(topo), dtype=np.float64)
        t = self.table
        if len(t):
            owned = t.domain_id >= 0
            leaf += np.bincount(
                t.domain_id[owned],
                weights=self._committed_draw(recv_rows)[owned],
                minlength=len(topo),
            )
        committed = topo.aggregate_leaves(leaf)
        extra = np.clip(caps - committed, 0.0, None)
        return extra, committed, caps

    # -- node state ----------------------------------------------------------

    @property
    def nodes(self) -> list[NodeState]:
        """NodeState views of the columnar table (a fresh list each access;
        assign a node list to replace the cluster state)."""
        return self.table.views()

    @nodes.setter
    def nodes(self, value: Sequence[NodeState]) -> None:
        table = NodeTable.from_nodes(value)
        if self.topology is not None and len(table):
            # intern before swapping state in: a failed leaf_of leaves the
            # sim's previous table intact
            table.domain_id = self.topology.leaf_of(table.node_ids).astype(np.int32)
        self.table = table

    def _surface(self, node: NodeState) -> PowerSurface:
        return self._surface_of(node.base_app, node.slowdown)

    def _surface_of(self, base_app: str, slowdown: float) -> PowerSurface:
        s = self.surfaces[base_app]
        if slowdown == 1.0:
            return s
        key = (base_app, slowdown)
        hit = self._slowed.get(key)
        if hit is None or hit.base is not s:
            hit = _SlowedSurface(s, slowdown)
            self._slowed[key] = hit
        return hit

    def _natural_draws(self) -> np.ndarray:
        """[n, 2] natural (uncapped) component draws, one surface query per
        distinct base app."""
        t = self.table
        nat = np.empty((len(t), 2), dtype=np.float64)
        for gid in np.unique(t.base_gid):
            c, g = self.surfaces[t.strings[gid]].power_draw(1e9, 1e9)
            nat[t.base_gid == gid] = (float(c), float(g))
        return nat

    def _donor_mask(self) -> tuple[np.ndarray, np.ndarray]:
        """(natural draws [n, 2], donor mask [n]): a node donates iff its
        natural draw sits below its caps on both components (margin 1 W).
        The one donor predicate shared by partitioning and the per-domain
        committed-draw accounting."""
        t = self.table
        nat = self._natural_draws()
        slack = t.caps - nat
        donor = t.alive & (slack[:, 0] > 1.0) & (slack[:, 1] > 1.0)
        return nat, donor

    def partition_rows(self) -> tuple[np.ndarray, np.ndarray, float]:
        """Array-native partition: (donor_rows, receiver_rows, pool).

        A node donates iff its natural draw sits below its caps on both
        components (margin 1 W); a dead node donates its entire cap
        allotment.  Memoized per (table, version, natural draws): unchanged
        rounds return the *same* row-array objects, which the receiver
        batch and measurement caches use as identity tokens.
        """
        t = self.table
        if not len(t):
            z = np.empty(0, dtype=np.int64)
            return z, z, 0.0
        nat = self._natural_draws()
        c = self._part_cache
        if c is not None and c[0] is t and c[1] == t.version and np.array_equal(c[2], nat):
            return c[3:]
        _, donor = self._donor_mask()
        recv = t.alive & ~donor
        dead = ~t.alive
        pool = float(t.caps[dead].sum() + (t.caps - nat)[donor].sum())
        out = (np.flatnonzero(donor), np.flatnonzero(recv), pool)
        self._part_cache = (t, t.version, nat, *out)
        return out

    def partition(self) -> tuple[list[NodeState], list[NodeState], float]:
        """(donors, receivers, reclaimed_pool) as NodeState views."""
        donors, recv, pool = self.partition_rows()
        return self.table.views(donors), self.table.views(recv), pool

    # -- events ---------------------------------------------------------------

    def apply_events(self, events: Sequence) -> list[str]:
        """Apply one round's scenario events to the table's columns in
        order (later events see earlier ones); returns affected instance
        names.  The rows each event touched are logged as one table bump."""
        t = self.table
        touched: list[str] = []
        dirty: list[np.ndarray] = []
        for event in events:
            if isinstance(event, scenario_mod.NodeFailure):
                rows = np.flatnonzero(
                    np.isin(t.node_ids, np.asarray(event.node_ids))
                )
                touched.extend(t.names[r] for r in rows)
                t.alive[rows] = False
                dirty.append(rows)
            elif isinstance(event, scenario_mod.StragglerOnset):
                rows = np.flatnonzero(t.node_ids == event.node_id)
                t.slowdown[rows] = event.slowdown
                touched.extend(t.names[r] for r in rows)
                dirty.append(rows)
            elif isinstance(event, scenario_mod.PhaseChange):
                if event.surface_id not in self.surfaces:
                    raise KeyError(f"unknown surface {event.surface_id!r}")
                rows = np.flatnonzero(t.node_ids == event.node_id)
                gid = np.int32(t.interner.intern(event.surface_id))
                t.base_gid[rows] = gid
                t.sid_gid[rows] = gid
                touched.extend(t.names[r] for r in rows)
                dirty.append(rows)
            elif isinstance(event, scenario_mod.NodeArrival):
                if event.surface is not None:
                    self.surfaces = {
                        **self.surfaces, event.app.name: event.surface
                    }
                if event.app.name not in self.surfaces:
                    raise KeyError(
                        f"no surface for arriving app {event.app.name!r}"
                    )
                nid = t.next_node_id()
                domain_id = -1
                if self.topology is not None:
                    if event.domain is not None:
                        domain_id = self.topology.require_leaf(event.domain)
                    else:
                        # the assigned id must fall inside some leaf range
                        try:
                            domain_id = int(self.topology.leaf_of([nid])[0])
                        except ValueError:
                            raise ValueError(
                                f"arrival of {event.app.name!r} at round "
                                f"{event.round} got node id {nid}, which no "
                                f"leaf domain owns — pass "
                                f"NodeArrival(domain=...) to place it"
                            ) from None
                caps = event.caps or (self.system.init_cpu, self.system.init_gpu)
                t.append(
                    node_id=nid,
                    name=f"{event.app.name}#n{nid}",
                    base_app=event.app.name,
                    surface_id=event.app.surface_id,
                    sclass=event.app.sclass,
                    caps=caps,
                    domain_id=domain_id,
                )
                dirty.append(np.array([len(t) - 1], dtype=np.int64))
            elif isinstance(event, scenario_mod.DomainCapChange):
                if self.topology is None:
                    raise ValueError(
                        "DomainCapChange requires an attached PowerTopology"
                    )
                if event.domain not in self.topology.index:
                    raise KeyError(f"unknown domain {event.domain!r}")
                self._cap_overrides.set(
                    self.topology.index[event.domain], event.round, event.cap
                )
            else:
                known = ", ".join(
                    c.__name__ for c in scenario_mod.Event.__args__
                )
                raise TypeError(
                    f"unknown event type {type(event).__name__!r}: {event!r} "
                    f"(expected one of: {known}; fault events attach via "
                    f"Scenario.with_faults, not the event timeline)"
                )
        rows = (
            np.unique(np.concatenate(dirty))
            if dirty
            else np.empty(0, dtype=np.int64)
        )
        t.bump(rows)
        return touched

    # -- measurement ----------------------------------------------------------

    def _measure_groups(self, rows: np.ndarray):
        """Distinct (base surface, slowdown) classes among ``rows`` as
        (gid, slowdown, member positions into ``rows``) triples, in
        (gid, slowdown) order.  Memoized per (table, version, rows object):
        the batch freshness probe, the surface fill and the measurement
        share one grouping per round."""
        t = self.table
        c = self._measure_groups_cache
        if c is not None and c[0] is t and c[1] == t.version and c[2] is rows:
            return c[3]
        sl = t.slowdown[rows]
        uniq_s, s_rank = np.unique(sl, return_inverse=True)
        key = t.base_gid[rows].astype(np.int64) * len(uniq_s) + s_rank
        uniq, inv = np.unique(key, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(uniq))
        splits = np.split(order, np.cumsum(counts)[:-1])
        ns = len(uniq_s)
        groups = [
            (int(uniq[k] // ns), float(uniq_s[uniq[k] % ns]), splits[k])
            for k in range(len(uniq))
        ]
        self._measure_groups_cache = (t, t.version, rows, groups)
        return groups

    def _measure_rows(
        self,
        rows: np.ndarray,
        base: np.ndarray,
        new: np.ndarray,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized measurement: per-receiver mean measured runtimes at
        (baseline, allocated) caps plus relative improvements.  One surface
        evaluation per (surface, slowdown) class and one RNG fill for the
        whole ``[n, n_repeats, 2]`` noise block."""
        n = len(rows)
        if n == 0:
            z = np.zeros(0, dtype=np.float64)
            return z, z, z
        strings = self.table.strings
        t_base = np.empty(n, dtype=np.float64)
        t_new = np.empty(n, dtype=np.float64)
        for gid, slowdown, ii in self._measure_groups(rows):
            surf = self.surfaces[strings[gid]]
            tn = np.asarray(surf.runtime(new[ii, 0], new[ii, 1]), np.float64)
            t_new[ii] = tn * slowdown
            tb = np.asarray(surf.runtime(base[ii, 0], base[ii, 1]), np.float64)
            t_base[ii] = tb * slowdown

        sigma = self.system.noise_sigma
        if sigma > 0:
            # C-order fill == the sequential per-(node, repeat, base/new)
            # scalar draws of the legacy loop
            factors = np.exp(rng.normal(0.0, sigma, size=(n, self.n_repeats, 2)))
            t0 = (t_base[:, None] * factors[:, :, 0]).mean(axis=1)
            t1 = (t_new[:, None] * factors[:, :, 1]).mean(axis=1)
        else:
            t0, t1 = t_base, t_new
        imp = (t0 - t1) / t0
        return t0, t1, imp

    # -- rounds ---------------------------------------------------------------

    def round_rng(self, policy: str, round_index: int) -> np.random.Generator:
        """Measurement RNG: round 0 replays the legacy run_round stream."""
        return np.random.default_rng(
            self.seed
            + zlib.crc32(policy.encode()) % 100003
            + round_index * _ROUND_STRIDE
        )

    def _fill_true_surfaces(self, rows: np.ndarray, surfaces: list) -> None:
        strings = self.table.strings
        for gid, slowdown, ii in self._measure_groups(rows):
            surf = self._surface_of(strings[gid], slowdown)
            for i in ii:
                surfaces[i] = surf

    @staticmethod
    def _rows_ascending(rows: np.ndarray) -> bool:
        """The delta-patched batch position-matches rows via searchsorted /
        setdiff1d, which need ascending (partition-ordered) row arrays;
        explicit ``run_round(receivers=...)`` callers may pass any order
        and then get a full rebuild."""
        return len(rows) < 2 or bool(np.all(rows[1:] > rows[:-1]))

    def _batch_surfaces_fresh(self, rows: np.ndarray, batch) -> bool:
        """One identity probe per (surface, slowdown) class: catches true
        surfaces swapped without a table bump (direct reassignment)."""
        strings = self.table.strings
        for gid, slowdown, ii in self._measure_groups(rows):
            if batch.surfaces[ii[0]] is not self._surface_of(
                strings[gid], slowdown
            ):
                return False
        return True

    def _patch_batch(
        self, mode: str, c: tuple, rows: np.ndarray
    ) -> ReceiverBatch | None:
        """Derive this round's batch of ``mode`` (``"true"`` surfaces or
        ``"skip"``: none) from the cached one (built on the same table), or
        None to force a full rebuild.

        In order: the cached batch comes back unchanged when nothing moved
        (same version, same rows object, surfaces still identity-fresh); a
        copy-on-write patched batch carrying the delta contract comes back
        when the dirty-row log bounds what changed and the patched surfaces
        probe fresh; otherwise None — unbounded change, non-partition row
        order, or a surface swapped without dirtying its rows (e.g. a
        NodeArrival re-registering an app's ground truth).
        """
        t = self.table
        _, _, c_version, c_rows, c_batch = c
        if c_version == t.version and c_rows is rows:
            if mode != "true" or self._batch_surfaces_fresh(rows, c_batch):
                return c_batch
            return None  # surfaces swapped underneath: rebuild
        dirty = t.dirty_since(c_version)
        if (
            dirty is None
            or not self._rows_ascending(rows)
            or not self._rows_ascending(c_rows)
        ):
            return None
        joined = np.setdiff1d(rows, c_rows, assume_unique=True)
        left = np.setdiff1d(c_rows, rows, assume_unique=True)
        changed = np.union1d(
            np.intersect1d(dirty, rows, assume_unique=False), joined
        )
        pos = np.searchsorted(rows, changed)
        strings = t.strings
        if mode == "skip":
            surfaces: list = [None] * len(rows)
        else:
            surfaces = list(c_batch.surfaces)
        if len(joined) or len(left):
            # membership moved: carry surviving surfaces over by row id,
            # rebuild the positional columns
            names = [t.names[r] for r in rows]
            surface_ids = [strings[t.sid_gid[r]] for r in rows]
            if mode == "true":
                common = np.setdiff1d(rows, joined, assume_unique=True)
                sarr = np.empty(len(rows), dtype=object)
                old = np.array(c_batch.surfaces, dtype=object)
                sarr[np.searchsorted(rows, common)] = old[
                    np.searchsorted(c_rows, common)
                ]
                surfaces = sarr.tolist()
        else:
            names = list(c_batch.names)
            surface_ids = list(c_batch.surface_ids)
            for p in pos:
                surface_ids[p] = strings[t.sid_gid[rows[p]]]
        if mode == "true":
            for p in pos:
                r = rows[p]
                surfaces[p] = self._surface_of(
                    strings[t.base_gid[r]], float(t.slowdown[r])
                )
        batch = ReceiverBatch(
            names=names,
            surface_ids=surface_ids,
            baselines=t.caps[rows],
            surfaces=surfaces,
            domain_ids=t.domain_id[rows] if self.topology is not None else None,
            seq=next(_BATCH_SEQ),
            prev_seq=c_batch.seq,
            delta=tuple(int(p) for p in pos),
            removed=tuple(t.names[r] for r in left),
        )
        if mode == "true" and not self._batch_surfaces_fresh(rows, batch):
            return None
        self._batch_cache = (t, mode, t.version, rows, batch)
        return batch

    def _receiver_batch(
        self,
        rows: np.ndarray,
        policy_surfaces: Mapping[str, PowerSurface] | None,
        sees_truth: bool,
        *,
        skip_surfaces: bool = False,
    ) -> ReceiverBatch:
        """Columnar receiver view for group-collapsing controllers.

        ``skip_surfaces`` leaves the surface column unfilled for
        controllers that serve their own surfaces (``ecoshift_online``):
        ground truth never transits their inputs.

        True-surface and surface-less batches are cached per (mode, table
        version, receiver rows): an event-free round returns the previous
        batch object unchanged, and a round whose dirty rows the table's
        log bounds ships a patched copy with the changed positions in
        ``delta`` — the contract incremental controllers key their
        grouping on.  Batches of caller-given ``policy_surfaces`` are built
        fresh every round.
        """
        t = self.table
        mode = (
            "skip" if skip_surfaces
            else "true" if (policy_surfaces is None or sees_truth)
            else None
        )
        c = self._batch_cache
        if mode is not None and c is not None and c[0] is t and c[1] == mode:
            batch = self._patch_batch(mode, c, rows)
            if batch is not None:
                return batch
        names = [t.names[r] for r in rows]
        strings = t.strings
        surfaces = [None] * len(rows)
        if mode == "true":
            self._fill_true_surfaces(rows, surfaces)
        elif mode is None:
            surfaces = [policy_surfaces[nm] for nm in names]
        batch = ReceiverBatch(
            names=names,
            surface_ids=[strings[t.sid_gid[r]] for r in rows],
            baselines=t.caps[rows],
            surfaces=surfaces,
            domain_ids=t.domain_id[rows] if self.topology is not None else None,
            seq=next(_BATCH_SEQ),
        )
        if mode is not None:
            self._batch_cache = (t, mode, t.version, rows, batch)
        return batch

    def _check_domain_conservation(
        self,
        recv_rows: np.ndarray,
        names: Sequence[str],
        base: np.ndarray,
        new: np.ndarray,
        round_index: int,
        headroom: tuple[np.ndarray, np.ndarray, np.ndarray],
        *,
        enforce: bool,
    ) -> None:
        """Per-domain draw accounting after an allocation (``new`` the
        allocated caps aligned with ``names``).

        Every domain's draw (committed + allocated extra, aggregated up the
        tree) lands in ``last_domain_draw`` / ``last_domain_caps``; with
        ``enforce`` an allocation that spends past a domain's headroom
        raises (the hierarchical allocator's conservation guarantee).
        Flat controllers on a topology sim only get the accounting.
        """
        topo = self.topology
        t = self.table
        leaf = np.zeros(len(topo), dtype=np.float64)
        if len(names):
            extra_node = new.sum(axis=1) - base.sum(axis=1)
            leaf += np.bincount(
                t.domain_id[recv_rows], weights=extra_node, minlength=len(topo)
            )
        spend = topo.aggregate_leaves(leaf)
        extra, committed, caps = headroom
        draw = committed + spend
        dnames = topo.names
        self.last_domain_draw = dict(zip(dnames, draw.tolist()))
        self.last_domain_caps = dict(zip(dnames, caps.tolist()))
        if enforce:
            # the allocator answers for the extra it places: never past a
            # domain's headroom (a cap already below the committed draw is
            # unsatisfiable under the monotone-upgrade model: 0 headroom)
            over = np.flatnonzero(spend > extra + 1e-6)
            if over.size:
                i = int(over[0])
                raise RuntimeError(
                    f"round {round_index}: domain {dnames[i]!r} draws "
                    f"{draw[i]:.3f} W over its {caps[i]:.3f} W cap "
                    f"(allocated {spend[i]:.3f} W > {extra[i]:.3f} W headroom)"
                )

    def _actuate_and_guard(
        self,
        recv_rows: np.ndarray,
        names: Sequence[str],
        base: np.ndarray,
        new: np.ndarray,
        budget: float,
        round_index: int,
        headroom,
        injector,
    ):
        """Resolve actuation faults, then run the PowerGuard watchdog.

        **Actuation** replays this round's commanded caps through the
        per-receiver actuator registers: a NACKed receiver keeps its
        previously applied caps, a partial application moves only a
        fraction of the way from them, a delayed command lands *next*
        round (displacing that round's own command).  **PowerGuard** is
        the firmware-level safety net below the control-plane RPC channel:
        it checks the *applied* (post-fault) per-domain draw against the
        topology caps — and the cluster total against the round budget —
        and claws any overdraw back with the proportional emergency
        derate of ``PowerTopology.derate_factors``.  The derate lands
        within the same round, so a stuck actuator causes at most a
        sub-round excursion; registers settle on the post-derate caps, so
        the stuck state itself is safe from the next round on (DESIGN.md
        §18).

        Returns ``(applied, report, guard)``: the settled [n, 2] caps that
        measurement (and therefore telemetry) sees, the
        :class:`~repro_torch.cluster.faults.ActuationReport` for the controller,
        and the PowerGuard stats dict (overdraw/derate/excursions).
        """
        from repro_torch.cluster import faults as faults_mod

        t = self.table
        rows = np.asarray(recv_rows)
        self._grow_registers(len(t))
        # a receiver starts from last round's applied caps (the baseline if
        # it had none), and a command queued by last round's delay lands
        # now, displacing this round's own command
        prev = np.where(self._reg_has[rows, None], self._reg_caps[rows], base)
        cmd = np.where(self._pend_has[rows, None], self._pend_caps[rows], new)
        self._pend_has[rows] = False
        applied = cmd.copy()
        plan = injector.actuation_plan(round_index, list(names), t.node_ids[rows])
        if plan:
            pos = {nm: i for i, nm in enumerate(names)}
            idx: dict[str, list[int]] = {"nack": [], "partial": [], "delay": []}
            frac: list[float] = []
            for nm, (kind, param) in plan.items():
                idx[kind].append(pos[nm])
                if kind == "partial":
                    frac.append(param)
            nack, part, delay = (
                np.asarray(idx[k], dtype=np.int64) for k in ("nack", "partial", "delay")
            )
            applied[nack] = prev[nack]
            applied[part] = prev[part] + np.asarray(frac)[:, None] * (cmd[part] - prev[part])
            self._pend_caps[rows[delay]] = new[delay]
            self._pend_has[rows[delay]] = True
            applied[delay] = prev[delay]

        # -- PowerGuard: settle the applied caps under every power cap ----
        guard = {
            "overdraw_w": 0.0,
            "derate_w": 0.0,
            "excursion_domains": (),
        }
        extra_node = (
            applied.sum(axis=1) - base.sum(axis=1)
            if len(names)
            else np.zeros(0)
        )
        excursions: list[str] = []
        worst = 0.0
        pre_total = float(extra_node.sum()) if len(names) else 0.0
        if self.topology is not None and len(names):
            topo = self.topology
            leaf = np.zeros(len(topo), dtype=np.float64)
            leaf += np.bincount(
                t.domain_id[recv_rows], weights=extra_node, minlength=len(topo)
            )
            spend = topo.aggregate_leaves(leaf)
            allowed, committed, caps = headroom
            over = spend - allowed
            hot = np.flatnonzero(over > 1e-9)
            if hot.size:
                worst = float(over[hot].max())
                excursions.extend(topo.names[int(i)] for i in hot)
                factors = topo.derate_factors(spend, allowed)
                f_leaf = factors[t.domain_id[recv_rows]]
                applied = base + f_leaf[:, None] * (applied - base)
                extra_node = applied.sum(axis=1) - base.sum(axis=1)
        if len(names):
            tot = float(extra_node.sum())
            if tot > budget + 1e-9:
                worst = max(worst, tot - budget)
                if not excursions:
                    excursions.append("__budget__")
                scale = budget / tot if tot > 0 else 0.0
                applied = base + scale * (applied - base)
                extra_node = applied.sum(axis=1) - base.sum(axis=1)
            guard["derate_w"] = max(0.0, pre_total - float(extra_node.sum()))
        guard["overdraw_w"] = worst
        guard["excursion_domains"] = tuple(excursions)
        if self.topology is not None and len(names):
            # settled per-domain draw overwrites the commanded accounting
            topo = self.topology
            leaf = np.zeros(len(topo), dtype=np.float64)
            leaf += np.bincount(
                t.domain_id[recv_rows], weights=extra_node, minlength=len(topo)
            )
            spend = topo.aggregate_leaves(leaf)
            _, committed, caps = headroom
            self.last_domain_draw = dict(
                zip(topo.names, (committed + spend).tolist())
            )

        # -- settle registers + report ------------------------------------
        # non-receivers revert to baseline caps: they lose their registers
        # (and any queued command), so a later receiver round starts from
        # the table baseline again
        self._reg_has[:] = False
        self._reg_has[rows] = True
        self._reg_caps[rows] = applied
        queued = self._pend_has[rows]
        self._pend_has[:] = False
        self._pend_has[rows] = queued
        ok = np.all(np.abs(applied - new) <= 1e-9, axis=1)
        bad = np.flatnonzero(~ok)
        report = faults_mod.ActuationReport(
            round=round_index,
            acked=tuple(itertools.compress(names, ok.tolist())),
            nacked=tuple(names[i] for i in bad.tolist()),
            applied={
                names[i]: (a[0], a[1]) for i, a in zip(bad.tolist(), applied[bad].tolist())
            },
        )
        return applied, report, guard

    def _grow_registers(self, n: int) -> None:
        """Extend the actuator registers to ``n`` table rows (arrivals)."""
        grow = n - len(self._reg_has)
        if grow > 0:
            self._reg_caps = np.concatenate([self._reg_caps, np.zeros((grow, 2))])
            self._reg_has = np.concatenate([self._reg_has, np.zeros(grow, dtype=bool)])
            self._pend_caps = np.concatenate([self._pend_caps, np.zeros((grow, 2))])
            self._pend_has = np.concatenate([self._pend_has, np.zeros(grow, dtype=bool)])

    def run_round(
        self,
        controller,
        budget: float | None = None,
        *,
        policy_surfaces: Mapping[str, PowerSurface] | None = None,
        receivers: Sequence[NodeState] | None = None,
        round_index: int = 0,
        _recv_rows: np.ndarray | None = None,
        _fault_injector=None,
    ) -> EmulationResult:
        """One redistribution round under a stateful controller.

        ``policy_surfaces`` is what the policy sees (predicted surfaces for
        EcoShift; defaults to true surfaces keyed per instance).  ``budget``
        defaults to the donor-derived reclaimed pool.  On a topology sim a
        controller with ``supports_hierarchical`` allocates from a batch
        with leaf domain ids and the per-domain headroom; otherwise
        controllers with ``supports_grouped`` allocate from a columnar
        ``ReceiverBatch`` and everyone else gets the per-instance view.
        Under ``_fault_injector`` the commanded caps pass through the
        actuation faults and PowerGuard (:meth:`_actuate_and_guard`) before
        measurement, and the controller gets the actuation report.  Phase
        seconds of the round land in ``last_round_seconds``.
        """
        secs = self.last_round_seconds = {}
        t = self.table
        tp = _time.perf_counter()
        if receivers is not None:
            _recv_rows = self.table.rows_for_ids([n.node_id for n in receivers])
        if _recv_rows is not None and budget is not None:
            recv_rows = np.asarray(_recv_rows)
        else:
            _, part_rows, pool = self.partition_rows()
            recv_rows = (
                np.asarray(_recv_rows) if _recv_rows is not None else part_rows
            )
        b = float(pool if budget is None else budget)
        base = t.caps[recv_rows]
        hierarchical = self.topology is not None and getattr(
            controller, "supports_hierarchical", False
        )
        headroom = (
            self.domain_headroom(round_index, recv_rows)
            if self.topology is not None
            else None
        )
        secs["partition_s"] = _time.perf_counter() - tp

        tp = _time.perf_counter()
        batch = None
        if hierarchical or getattr(controller, "supports_grouped", False):
            batch = self._receiver_batch(
                recv_rows,
                policy_surfaces,
                controller.sees_truth,
                skip_surfaces=getattr(controller, "serves_own_surfaces", False),
            )
            names = batch.names
        secs["batch_s"] = _time.perf_counter() - tp

        tp = _time.perf_counter()
        if hierarchical:
            controller.bind_topology(self.topology)
            alloc = controller.allocate_hierarchical(batch, b, headroom[0])
        elif batch is not None:
            alloc = controller.allocate_grouped(batch, b)
        else:
            recv_nodes = t.views(recv_rows)
            names = [n.app.name for n in recv_nodes]
            recv_apps = [n.app for n in recv_nodes]
            baselines = {n.app.name: n.caps for n in recv_nodes}
            true_by_inst = {n.app.name: self._surface(n) for n in recv_nodes}
            seen = (
                policy_surfaces if policy_surfaces is not None else true_by_inst
            )
            if controller.sees_truth:
                seen = true_by_inst
            alloc = controller.allocate(recv_apps, baselines, b, seen)
        secs["allocate_s"] = _time.perf_counter() - tp

        tp = _time.perf_counter()
        new = np.array([alloc.caps[nm] for nm in names], dtype=np.float64)
        if self.topology is not None:
            self._check_domain_conservation(
                recv_rows, names, base, new, round_index, headroom,
                enforce=hierarchical,
            )
        secs["conserve_s"] = _time.perf_counter() - tp

        tp = _time.perf_counter()
        self.last_actuation = None
        self.last_guard = None
        if _fault_injector is not None:
            new, report, guard = self._actuate_and_guard(
                recv_rows, names, base, new, b, round_index,
                headroom, _fault_injector,
            )
            self.last_actuation = report
            self.last_guard = guard
            controller.notify_actuation(report)
        secs["actuate_s"] = _time.perf_counter() - tp

        tp = _time.perf_counter()
        rng = self.round_rng(controller.policy, round_index)
        t0, t1, imp = self._measure_rows(recv_rows, base, new, rng)
        improvements = dict(zip(names, imp.tolist()))
        self.last_telemetry = TelemetryBatch(
            round=round_index,
            inst_gids=t.name_gid[recv_rows],
            app_gids=t.base_gid[recv_rows],
            strings=t.strings,
            baseline_caps=base,
            allocated_caps=new,
            t_baseline=t0,
            t_allocated=t1,
            improvement=imp,
        )
        secs["measure_s"] = _time.perf_counter() - tp
        return EmulationResult(
            policy=controller.policy,
            improvements=improvements,
            allocation=alloc,
            budget=b,
        )

    def run(
        self,
        scenario: Scenario,
        controller,
        *,
        policy_surfaces: Mapping[str, PowerSurface]
        | Callable[["ClusterSim"], Mapping[str, PowerSurface]]
        | None = None,
    ) -> SimResult:
        """Step a scenario: per round, apply events -> allocate -> measure
        -> feed telemetry back to the controller.

        ``controller`` is a Controller or a registered policy name (built
        on this sim's device).  ``policy_surfaces`` may be a mapping or a
        callable ``sim -> mapping`` re-evaluated each round.  A scenario's
        topology is attached here unless the sim already carries one (a
        different one raises).  Fault events run through a fresh
        :class:`~repro_torch.cluster.faults.FaultInjector` (crashes at round
        start, actuation and PowerGuard in the round, telemetry delivery
        after it), and a controller with ``horizon > 1`` gets the budget
        outlook before each round.
        """
        if isinstance(controller, str):
            from repro_torch.core import policies as policies_mod

            controller = policies_mod.get_controller(
                controller, self.system, device=self.device
            )
        if scenario.topology is not None:
            if self.topology is None:
                self.attach_topology(scenario.topology)
            elif self.topology is not scenario.topology:
                raise ValueError(
                    "scenario topology differs from the sim's attached one"
                )
        injector = None
        if scenario.faults:
            from repro_torch.cluster import faults as faults_mod

            injector = faults_mod.FaultInjector(scenario.faults)
            # fresh actuator state per run: registers model the physical
            # caps of this run's actuation channel
            self._reg_has[:] = False
            self._pend_has[:] = False
        records: list[RoundRecord] = []
        # receding-horizon controllers get a per-round budget outlook: the
        # provider-backed cap forecast plus the CO2 (or price) weights
        horizon = int(getattr(controller, "horizon", 1) or 1)
        feeds_outlook = horizon > 1 and hasattr(controller, "set_budget_outlook")
        for r in range(scenario.n_rounds):
            if injector is not None:
                # crashes fire at round start, before the round's events and
                # solve: the replacement process handles the whole round
                injector.maybe_crash(r, controller)
            events = scenario.events_at(r)
            touched = self.apply_events(events) if events else []
            if touched:
                controller.invalidate(touched)
            seen = (
                policy_surfaces(self)
                if callable(policy_surfaces)
                else policy_surfaces
            )
            _, recv_rows, pool = self.partition_rows()
            b = scenario.budget_at(r)
            if feeds_outlook:
                caps = [
                    pool if c is None else float(c)
                    for c in scenario.budget_forecast(r, horizon)
                ]
                caps[0] = float(pool if b is None else b)
                weights = scenario.carbon_forecast(r, horizon)
                if all(w is None for w in weights):
                    weights = scenario.price_forecast(r, horizon)
                controller.set_budget_outlook(
                    caps,
                    None
                    if all(w is None for w in weights)
                    else [1.0 if w is None else float(w) for w in weights],
                )
            res = self.run_round(
                controller,
                budget=pool if b is None else b,
                policy_surfaces=seen,
                round_index=r,
                _recv_rows=recv_rows,
                _fault_injector=injector,
            )
            if injector is not None:
                delivered, tkinds = injector.deliver(r, self.last_telemetry)
            else:
                delivered, tkinds = [self.last_telemetry], ()
            guard = self.last_guard or {}
            report = self.last_actuation
            records.append(
                RoundRecord(
                    round=r,
                    result=res,
                    pool=pool,
                    n_alive=int(np.count_nonzero(self.table.alive)),
                    events=events,
                    power_price=scenario.price_at(r),
                    carbon_intensity=scenario.carbon_at(r),
                    telemetry=self.last_telemetry,
                    seconds=dict(self.last_round_seconds),
                    domain_draw=self.last_domain_draw,
                    domain_caps=self.last_domain_caps,
                    overdraw_w=float(guard.get("overdraw_w", 0.0)),
                    derate_w=float(guard.get("derate_w", 0.0)),
                    excursion_domains=tuple(guard.get("excursion_domains", ())),
                    nacked=tuple(report.nacked) if report is not None else (),
                    telemetry_faults=tkinds,
                )
            )
            for tb in delivered:
                controller.ingest_telemetry(tb)
            if injector is not None:
                injector.end_round(r, controller)
        return SimResult(policy=controller.policy, records=records)
