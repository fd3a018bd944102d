"""Stateful policy controllers for the multi-round cluster engine.

One controller per policy:

 * ``uniform`` / ``dps`` / ``mixed_adaptive`` — stateless wrappers of the
   pure heuristic policies;
 * ``oracle`` — the exact optimum on true surfaces (``sees_truth``): brute
   force at <= 10 receivers and the sparse DP beyond, on warm option
   tables;
 * ``ecoshift_online`` — EcoShift with an
   :class:`~repro_torch.cluster.predictor.OnlinePredictor` as its surface
   source: it serves its own surfaces (the engine hands it none), ingests
   each round's telemetry and refits on the predictor's device;
 * ``ecoshift`` — described below;
 * ``ecoshift_hier`` — EcoShift on a power-domain tree: receivers collapse
   into behaviour classes within each leaf domain, and
   ``mckp.solve_hierarchical`` (or, with ``fused=True``,
   ``mckp.solve_hierarchical_fused`` on the device) splits the budget
   under every domain's headroom.  The engine hands it the per-domain
   headroom each round; ``last_domain_spent`` reports each domain's spend.

The EcoShift controller caches per-receiver and per-behaviour-class
``OptionTable``s across rounds (tables are built to the grid's headroom
ceiling, so they are budget-independent and survive a changing pool) and
solves each round with ``solver``:

 * ``"sparse"`` (the default) — the host sparse solvers.  On
   engine-sequenced batches the round is incremental: the behaviour-class
   grouping follows the batch deltas, the solve reuses content-keyed
   curve/pick/plan caches, and an unchanged round returns its cached
   ``Allocation``.  With ``fused=True`` the incremental round runs on the
   device (``mckp.solve_grouped_fused``: resident option banks, all
   stages of the round in one sparse-option stage kernel launch) and
   routes to the host only for the reference's fallback reasons, which
   ``last_solver``/``last_fallback_reason``/``fused_stats()`` report;
 * ``"pallas"`` — the dense DP with every (max,+) stage on the hand-written
   CUDA kernel (its plain PyTorch version for a CPU ``device``);
 * ``"jax"`` — the same dense DP on the plain PyTorch version;
 * ``"dense"`` — the numpy dense DP.

The names are the reference's.  Receding-horizon (MPC) planning and the
fault paths (NACK pins, snapshots) raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import curves, mckp
from repro_torch.core import policies as policies_mod
from repro_torch.core.curves import OptionTable
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import (
    Allocation,
    AppSpec,
    FusedRoundStats,
    ReceiverBatch,
    SystemSpec,
    as_receiver_order,
)
from repro_torch.device import resolve_device

FAULTS_NOT_PORTED = (
    "the fault paths (actuation reports, NACK pins, snapshot/restore) are "
    "not ported yet: ROADMAP.md, queue 1, item 5"
)


class Controller:
    """Base: a policy with per-round ``allocate`` plus warm-state hooks."""

    #: key into ``POLICIES`` / the legacy ``run_round`` name
    policy: str = ""
    #: True for policies that always see ground-truth surfaces (Oracle)
    sees_truth: bool = False
    #: True when the controller consumes a columnar ``ReceiverBatch`` via
    #: ``allocate_grouped`` (group-collapsed DP controllers)
    supports_grouped: bool = False

    def __init__(self, system: SystemSpec):
        self.system = system

    def allocate(
        self,
        receivers: Sequence[AppSpec],
        baselines: Mapping[str, tuple[float, float]],
        budget: float,
        surfaces: Mapping[str, PowerSurface],
    ) -> Allocation:
        raise NotImplementedError

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        """Drop cached per-receiver state (``None`` = everything)."""

    def ingest_telemetry(self, records: Sequence) -> None:
        """Consume one round's noisy measurements; the engine calls this
        after every measured round.  Predictor-backed controllers (not
        ported yet) refresh their surfaces here; everyone else ignores it."""

    def notify_actuation(self, report) -> None:
        raise NotImplementedError(FAULTS_NOT_PORTED)

    def snapshot(self) -> dict:
        raise NotImplementedError(FAULTS_NOT_PORTED)

    def restore(self, state: Mapping) -> None:
        raise NotImplementedError(FAULTS_NOT_PORTED)


class _StatelessController(Controller):
    """Wraps a pure policy function; nothing carries across rounds.
    ``device`` is accepted so every controller builds alike; these
    policies run on the host."""

    def __init__(self, system: SystemSpec, *, device=None):
        super().__init__(system)

    def allocate(self, receivers, baselines, budget, surfaces):
        fn = policies_mod.POLICIES[self.policy]
        return fn(receivers, baselines, budget, self.system, surfaces)


@policies_mod.register_controller("uniform")
class UniformController(_StatelessController):
    policy = "uniform"


@policies_mod.register_controller("dps")
class DPSController(_StatelessController):
    policy = "dps"


@policies_mod.register_controller("mixed_adaptive")
class MixedAdaptiveController(_StatelessController):
    policy = "mixed_adaptive"


@dataclasses.dataclass
class ControllerConfig:
    """Construction config of the EcoShift-family and Oracle controllers.

    The defaults are the reference's.  ``horizon > 1`` selects receding-
    horizon planning, which is not ported yet and raises.  ``device`` is
    where the fused round and the ``"jax"``/``"pallas"`` stages run (None =
    the CUDA card).
    """

    solver: str = "sparse"
    unit: float = 1.0
    grouped: bool = True
    #: delta-driven steady-state rounds on engine-sequenced batches
    #: (sparse solver only)
    incremental: bool = True
    #: device-resident fused rounds (incremental sparse path only)
    fused: bool = False
    #: repro_torch.cluster.predictor.OnlinePredictor (required by the
    #: online controller; optional surface source for the hier controller)
    predictor: object | None = None
    #: Oracle brute-force toggle (None = auto, <= 10 receivers)
    exhaustive: bool | None = None
    #: receding-horizon plan length in rounds (1 = myopic)
    horizon: int = 1
    device: str | torch.device | None = None

    def merged(self, **overrides) -> "ControllerConfig":
        """Copy with every non-None override applied (an explicit keyword
        beats the config field)."""
        changes = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **changes) if changes else self


def _served_replace(batch: ReceiverBatch, served) -> ReceiverBatch:
    """Swap in predictor-served surfaces and strip the delta sequence.

    Served surfaces move on telemetry, outside the engine's delta bound,
    so the batch must not claim delta continuity (seq=0 routes grouping
    down the from-scratch path)."""
    return dataclasses.replace(
        batch, surfaces=served, seq=0, prev_seq=None, delta=None, removed=()
    )


class _ClassRec:
    """One live behaviour class inside a :class:`_GroupingState` scope."""

    __slots__ = ("surf", "members", "table", "group")

    def __init__(self, surf, table):
        self.surf = surf
        #: name-sorted member list, maintained incrementally
        self.members: list[str] = []
        self.table = table
        #: lazily rebuilt frozen GroupedOptions (None = members moved)
        self.group = None


class _GroupingState:
    """Persistent behaviour-class grouping, updated by batch deltas.

    Mirrors ``mckp.collapse_receivers`` — receivers sharing (surface
    identity, baseline) form one class — but *across rounds*: the engine's
    :class:`~repro_torch.core.types.ReceiverBatch` delta contract names exactly
    the positions whose surface/baseline moved and the receivers that
    left, so a steady-state round updates O(churn) classes instead of
    re-collapsing the whole cluster.  ``scope`` partitions classes (leaf
    power-domain id on the hierarchical path, 0 on the flat path).
    Unchanged scopes keep their frozen ``GroupedOptions`` tuples — object
    identity downstream caches (plans, leaf solutions) key on.
    """

    __slots__ = ("seq", "scopes", "of_name", "_groups_cache")

    def __init__(self):
        #: batch seq this state mirrors (None = never built)
        self.seq: int | None = None
        self.scopes: dict[int, dict[tuple, _ClassRec]] = {}
        self.of_name: dict[str, tuple[int, tuple]] = {}
        self._groups_cache: dict[int, tuple] = {}

    def reset(self) -> None:
        self.seq = None
        self.scopes.clear()
        self.of_name.clear()
        self._groups_cache.clear()

    def sync(self, batch, leaf_ids, table_for) -> None:
        """Bring the grouping in line with ``batch`` (delta or rebuild)."""
        if batch.seq == self.seq and self.seq is not None:
            return
        if (
            batch.prev_seq is not None
            and batch.prev_seq == self.seq
            and batch.delta is not None
        ):
            for name in batch.removed:
                self._remove(name)
            for pos in batch.delta:
                self._place(batch, pos, leaf_ids, table_for)
            self.seq = batch.seq
            return
        self._rebuild(batch, leaf_ids, table_for)
        self.seq = batch.seq

    def _rebuild(self, batch, leaf_ids, table_for) -> None:
        self.scopes.clear()
        self.of_name.clear()
        self._groups_cache.clear()
        scopes = (
            leaf_ids.tolist() if leaf_ids is not None else [0] * len(batch)
        )
        bl = batch.baselines.tolist()
        for name, surf, base, scope in zip(
            batch.names, batch.surfaces, bl, scopes
        ):
            base = (base[0], base[1])
            ckey = (id(surf), base)
            recs = self.scopes.setdefault(scope, {})
            rec = recs.get(ckey)
            if rec is None or rec.surf is not surf:
                rec = _ClassRec(surf, table_for(surf, base))
                recs[ckey] = rec
            rec.members.append(name)
            self.of_name[name] = (scope, ckey)
        for recs in self.scopes.values():
            for rec in recs.values():
                rec.members.sort()

    def _place(self, batch, pos, leaf_ids, table_for) -> None:
        name = batch.names[pos]
        surf = batch.surfaces[pos]
        b = batch.baselines[pos]
        base = (float(b[0]), float(b[1]))
        scope = int(leaf_ids[pos]) if leaf_ids is not None else 0
        ckey = (id(surf), base)
        old = self.of_name.get(name)
        if old is not None:
            oscope, ockey = old
            if oscope == scope and ockey == ckey:
                rec = self.scopes[scope][ckey]
                if rec.surf is surf:
                    return  # nothing actually moved
            self._remove(name)
        recs = self.scopes.setdefault(scope, {})
        rec = recs.get(ckey)
        if rec is None or rec.surf is not surf:
            rec = _ClassRec(surf, table_for(surf, base))
            recs[ckey] = rec
        bisect.insort(rec.members, name)
        rec.group = None
        self.of_name[name] = (scope, ckey)
        self._groups_cache.pop(scope, None)

    def _remove(self, name: str) -> None:
        loc = self.of_name.pop(name, None)
        if loc is None:
            return
        scope, ckey = loc
        rec = self.scopes[scope][ckey]
        i = bisect.bisect_left(rec.members, name)
        if i < len(rec.members) and rec.members[i] == name:
            del rec.members[i]
        rec.group = None
        if not rec.members:
            del self.scopes[scope][ckey]
        self._groups_cache.pop(scope, None)

    def groups(self, scope: int) -> tuple:
        """Frozen GroupedOptions of one scope (tuple reused while clean)."""
        g = self._groups_cache.get(scope)
        if g is None:
            out = []
            for rec in self.scopes.get(scope, {}).values():
                if rec.group is None:
                    rec.group = mckp.GroupedOptions(
                        table=rec.table, members=tuple(rec.members)
                    )
                out.append(rec.group)
            g = tuple(out)
            self._groups_cache[scope] = g
        return g

    def by_scope(self) -> dict[int, tuple]:
        return {scope: self.groups(scope) for scope in self.scopes}


class _OptionCachingController(Controller):
    """Warm ``OptionTable`` caches for the DP-based policies.

    Two table layers: per-instance tables keyed by name (the ungrouped
    path), and group tables keyed by (surface identity, baseline), one per
    behaviour class.  Keys are identity based, so a straggler or phase
    change swaps the surface object and the stale entry stops matching.
    Tables are built to the grid headroom ceiling: every solver skips
    options costing more than the round budget.  Beside them, the sparse
    solvers' content-keyed caches (aggregate curves, doubling chains, pick
    multisets, merged-class plans), the whole-``Allocation`` cache of the
    incremental path and the delta-maintained class grouping.  Every cache
    is a bounded LRU: an eviction recomputes, it never changes a result.
    """

    #: LRU bounds of the warm caches
    MAX_GROUP_TABLES = 512
    MAX_AGG_CURVES = 8192
    MAX_PICKS = 16384
    MAX_PLANS = 256
    MAX_ALLOCATIONS = 8

    def __init__(self, system: SystemSpec):
        super().__init__(system)
        #: name -> (baseline, surface, table); surface compared by identity
        self._options: dict[
            str, tuple[tuple[float, float], PowerSurface, OptionTable]
        ] = {}
        #: (id(surface), baseline) -> (surface, table)
        self._group_tables = mckp.LRUCache(self.MAX_GROUP_TABLES)
        #: (table digest, multiplicity, budget) -> aggregate sparse curve
        self._agg_curves = mckp.LRUCache(self.MAX_AGG_CURVES)
        #: (digest, budget) -> doubling chain (shielded from (d, m) churn)
        self._chain_cache = mckp.LRUCache(512)
        #: (curve key, spend) -> unwound pick multiset
        self._pick_cache = mckp.LRUCache(self.MAX_PICKS)
        #: group-token tuple -> merged-class plan
        self._plan_cache = mckp.LRUCache(self.MAX_PLANS)
        #: (group tokens, budget) -> warm Allocation
        self._alloc_cache = mckp.LRUCache(self.MAX_ALLOCATIONS)
        #: delta-maintained behaviour-class grouping
        self._grouping = _GroupingState()

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        if names is None:
            self._options.clear()
            self._group_tables.clear()
            self._agg_curves.clear()
            self._chain_cache.clear()
            self._pick_cache.clear()
            self._plan_cache.clear()
            self._alloc_cache.clear()
            self._grouping.reset()
        else:
            for n in names:
                self._options.pop(n, None)

    @property
    def cached_tables(self) -> int:
        return len(self._options) + len(self._group_tables)

    def _options_for(
        self,
        receivers: Sequence[AppSpec],
        baselines: Mapping[str, tuple[float, float]],
        surfaces: Mapping[str, PowerSurface],
    ) -> list[OptionTable]:
        out = []
        for a in as_receiver_order(receivers):
            base = baselines[a.name]
            surf = surfaces[a.name]
            hit = self._options.get(a.name)
            if hit is not None and hit[0] == base and hit[1] is surf:
                out.append(hit[2])
                continue
            table = curves.build_options(
                a.name, surf, base, self.system.grid, np.inf
            )
            self._options[a.name] = (base, surf, table)
            out.append(table)
        return out

    def _group_table(
        self, surf: PowerSurface, base: tuple[float, float]
    ) -> OptionTable:
        key = (id(surf), base)
        hit = self._group_tables.get(key)
        if hit is not None and hit[0] is surf:
            return hit[1]
        table = curves.build_options("class", surf, base, self.system.grid, np.inf)
        self._group_tables[key] = (surf, table)
        return table

    def _grouped_options_for(
        self, batch: ReceiverBatch
    ) -> list[mckp.GroupedOptions]:
        """Collapse a receiver batch into behaviour-class groups (one warm
        option table per (surface identity, baseline))."""
        return mckp.collapse_receivers(
            batch.names, batch.surfaces, batch.baselines, self._group_table
        )


@policies_mod.register_controller("ecoshift")
class EcoShiftController(_OptionCachingController):
    """MCKP DP on (predicted) surfaces with warm option tables."""

    policy = "ecoshift"

    def __init__(
        self,
        system: SystemSpec,
        *,
        config: ControllerConfig | None = None,
        solver: str | None = None,
        unit: float | None = None,
        grouped: bool | None = None,
        incremental: bool | None = None,
        fused: bool | None = None,
        horizon: int | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(system)
        cfg = (config if config is not None else ControllerConfig()).merged(
            solver=solver, unit=unit, grouped=grouped,
            incremental=incremental, fused=fused, horizon=horizon, device=device,
        )
        if cfg.solver not in ("sparse", "dense", "jax", "pallas"):
            raise ValueError(f"unknown solver {cfg.solver!r}")
        if cfg.horizon > 1:
            raise NotImplementedError(
                "horizon > 1 (receding-horizon MPC planning) is not ported "
                "yet: ROADMAP.md, queue 1, item 5"
            )
        #: the resolved construction config
        self.config = cfg
        self.solver = cfg.solver
        self.unit = cfg.unit
        #: group-collapsed allocation (one behaviour class per shared
        #: table); False takes the per-instance path
        self.grouped = cfg.grouped
        #: delta-driven steady-state rounds (sparse solver, engine-
        #: sequenced batches); False re-collapses and re-solves every round
        self.incremental = cfg.incremental
        #: device-resident fused rounds on the incremental sparse path
        #: (ignored elsewhere, as in the reference)
        self.fused = cfg.fused
        self.device = resolve_device(cfg.device)
        #: resident device banks + capacity-slack layout for fused rounds
        self._fused_state = mckp.FusedState()
        #: 'fused' | 'host' | 'cache' — which path produced the last
        #: grouped solution
        self.last_solver: str | None = None
        #: why the last fused attempt routed to host ("" when it stayed
        #: fused, was not attempted, or hit the allocation cache)
        self.last_fallback_reason: str = ""
        #: device seconds inside the last fused round (0.0 for host rounds
        #: and allocation-cache hits)
        self.last_device_s: float = 0.0

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        super().invalidate(names)
        if names is None:
            self._fused_state.clear()

    @property
    def supports_grouped(self) -> bool:  # type: ignore[override]
        return self.grouped

    def fused_stats(self) -> FusedRoundStats:
        """Snapshot of the device-resident round counters."""
        return FusedRoundStats(**self._fused_state.stats)

    def fused_segments(self) -> dict:
        """Last fused round's wall-clock split (seconds): prep_s / patch_s /
        compact_s / dispatch_s / backtrack_s / assembly_s.  Empty until a
        fused round has been attempted."""
        return dict(self._fused_state.last_segments)

    def _try_fused_grouped(self, groups, budget) -> mckp.MCKPSolution | None:
        """One fused-round attempt; returns None to use the host path.
        Kernel build or launch errors propagate."""
        fstate = self._fused_state
        d0 = fstate.stats["device_s"]
        sol = mckp.solve_grouped_fused(
            groups,
            budget,
            fstate=fstate,
            curve_cache=self._agg_curves,
            pick_cache=self._pick_cache,
            plan_cache=self._plan_cache,
            chain_cache=self._chain_cache,
            device=self.device,
        )
        self.last_device_s = fstate.stats["device_s"] - d0
        return sol

    def _solve(self, options, budget) -> mckp.MCKPSolution:
        if self.solver == "sparse":
            return mckp.solve_sparse(options, budget)
        if self.solver == "dense":
            return mckp.solve_dense(options, budget, unit=self.unit)
        return mckp.solve_dense_jax(
            options, budget, unit=self.unit, backend=self.solver,
            device=self.device,
        )

    def allocate(self, receivers, baselines, budget, surfaces):
        options = self._options_for(receivers, baselines, surfaces)
        sol = self._solve(options, budget)
        return policies_mod.allocation_from_solution(
            sol, baselines, budget, self.system.grid
        )

    def allocate_grouped(self, batch: ReceiverBatch, budget: float) -> Allocation:
        """Group-collapsed round: receivers sharing (surface identity,
        baseline) solve as one behaviour class; bitwise equal to
        :meth:`allocate` on the same receivers.

        On the incremental path (sparse solver, engine-sequenced batches)
        the grouping follows the batch deltas, the solve reuses the
        content-keyed caches, and a round whose classes and budget are
        unchanged returns the cached Allocation (``last_solver = "cache"``).
        With ``fused=True`` the solve runs on the device; a round the
        fused path declines runs on the host with ``last_solver = "host"``
        and ``last_fallback_reason`` set."""
        incremental = (
            self.incremental
            and self.solver == "sparse"
            and getattr(batch, "seq", 0) != 0
        )
        if incremental:
            self._grouping.sync(batch, None, self._group_table)
            groups = self._grouping.groups(0)
            key = (
                tuple(sorted(mckp._group_token(g) for g in groups)),
                mckp._qkey(budget),
            )
            hit = self._alloc_cache.get(key)
            if hit is not None:
                self.last_solver = "cache"
                self.last_device_s = 0.0
                self.last_fallback_reason = ""
                return hit
        else:
            groups = self._grouped_options_for(batch)
            key = None
        sol = None
        self.last_device_s = 0.0
        self.last_fallback_reason = ""
        if incremental and self.fused:
            sol = self._try_fused_grouped(groups, budget)
            if sol is None:
                self.last_fallback_reason = self._fused_state.stats[
                    "fallback_reason"
                ]
        self.last_solver = "fused" if sol is not None else "host"
        if sol is None:
            sol = mckp.solve_grouped(
                groups,
                budget,
                solver=self.solver,
                unit=self.unit,
                curve_cache=self._agg_curves,
                pick_cache=self._pick_cache if incremental else None,
                plan_cache=self._plan_cache if incremental else None,
                chain_cache=self._chain_cache if incremental else None,
                device=self.device,
            )
        alloc = policies_mod.allocation_from_solution(
            sol, batch.baselines_map(), budget, self.system.grid
        )
        if key is not None:
            self._alloc_cache[key] = alloc
        return alloc

    def set_budget_outlook(self, caps, weights=None) -> None:
        raise NotImplementedError(
            "budget outlooks (MPC planning) are not ported yet: ROADMAP.md, "
            "queue 1, item 5"
        )

    def allocate_batch(
        self,
        receivers: Sequence[AppSpec],
        baselines: Mapping[str, tuple[float, float]],
        budgets: Sequence[float],
        surfaces: Mapping[str, PowerSurface],
    ) -> list[Allocation]:
        """Solve one receiver set under many budgets in one batched dense
        DP (each stage one row-batched launch over all budgets).

        Always solves on the dense ``unit``-watt grid: ``"pallas"`` keeps
        the kernel, any other solver takes the plain version (``"jax"``)."""
        options = self._options_for(receivers, baselines, surfaces)
        backend = "pallas" if self.solver == "pallas" else "jax"
        sols = mckp.solve_dense_jax_batch(
            [options] * len(budgets),
            list(budgets),
            unit=self.unit,
            backend=backend,
            device=self.device,
        )
        return [
            policies_mod.allocation_from_solution(
                sol, baselines, budget, self.system.grid
            )
            for budget, sol in zip(budgets, sols)
        ]


@policies_mod.register_controller("ecoshift_hier")
class EcoShiftHierController(EcoShiftController):
    """Topology-aware EcoShift: two-level capped-frontier MCKP (DESIGN.md §12).

    The engine hands this controller a columnar receiver batch with leaf
    domain ids plus the round's per-domain extra-power headroom; receivers
    collapse into behaviour classes within each leaf domain (the same warm
    identity-keyed group tables as the flat path), each leaf's class DP
    becomes a capped value-vs-spend frontier, and the upper-level DP splits
    the cluster budget across domains (``mckp.solve_hierarchical``).

    Warm state (``solver='sparse'``, the default): the shared aggregate-
    curve cache plus a frontier cache keyed by (per-class digest +
    multiplicity layout, quantized budget), both content-keyed, inside one
    ``mckp.HierState``.  With ``fused=True`` the incremental round runs on
    the device (``mckp.solve_hierarchical_fused``: the leaf scan and every
    combine wave as stage-kernel launches) and routes to the host only for
    the reference's fallback reasons.  The dense ``'jax'``/``'pallas'``
    path recomputes its layouts each round on the device.  Passing
    ``predictor`` serves every receiver surface from an
    :class:`~repro_torch.cluster.predictor.OnlinePredictor`, as
    ``ecoshift_online`` does.
    """

    policy = "ecoshift_hier"
    supports_hierarchical = True

    #: LRU bound of the leaf-frontier cache
    MAX_FRONTIERS = 512

    _NO_TOPOLOGY = (
        "ecoshift_hier allocates per power domain — attach a PowerTopology "
        "to the sim/scenario, or use 'ecoshift' for flat allocation"
    )

    def __init__(
        self,
        system: SystemSpec,
        *,
        config: ControllerConfig | None = None,
        solver: str | None = None,
        unit: float | None = None,
        predictor=None,
        incremental: bool | None = None,
        fused: bool | None = None,
        horizon: int | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = (config if config is not None else ControllerConfig()).merged(
            solver=solver, unit=unit, predictor=predictor,
            incremental=incremental, fused=fused, horizon=horizon, device=device,
        )
        super().__init__(system, config=cfg)
        #: repro_torch.core.topology.PowerTopology, bound by the engine
        #: (bind_topology)
        self.topology = None
        #: optional OnlinePredictor: serves surfaces, ingests telemetry
        self.predictor = cfg.predictor
        #: (class layout, quantized budget) -> leaf frontier DP arrays
        self._frontiers = mckp.LRUCache(self.MAX_FRONTIERS)
        #: persistent hierarchical warm state (frontier aggregation tree
        #: combines, pick multisets, leaf solutions, merged-class plans),
        #: content-keyed and LRU-bounded
        self._hier_state = mckp.HierState(
            curve_cache=self._agg_curves,
            frontier_cache=self._frontiers,
            chain_cache=self._chain_cache,
            pick_cache=self._pick_cache,
            plan_cache=self._plan_cache,
            max_leaf_solutions=128,
        )
        #: per-domain watts spent by the latest hierarchical solve
        self.last_domain_spent: dict[str, float] | None = None

    @property
    def serves_own_surfaces(self) -> bool:
        return self.predictor is not None

    def bind_topology(self, topology) -> None:
        """Attach (or swap) the domain tree; a swap drops warm state."""
        if self.topology is not None and self.topology is not topology:
            self.invalidate()
        self.topology = topology

    def _served_batch(self, batch: ReceiverBatch) -> ReceiverBatch:
        if self.predictor is None:
            return batch
        served = [
            self.predictor.surface_for(name, sid)
            for name, sid in zip(batch.names, batch.surface_ids)
        ]
        return _served_replace(batch, served)

    def allocate(self, receivers, baselines, budget, surfaces):
        # reached only when the engine has no topology attached: a silent
        # flat fallback under the hier name would hide the missing tree
        raise ValueError(self._NO_TOPOLOGY)

    def allocate_grouped(self, batch: ReceiverBatch, budget: float):
        raise ValueError(self._NO_TOPOLOGY)

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        super().invalidate(names)
        if names is None:
            self._frontiers.clear()
            self._hier_state.clear()

    def _grouped_options_by_leaf(
        self, batch: ReceiverBatch
    ) -> dict[int, list[mckp.GroupedOptions]]:
        """Per-leaf-domain behaviour-class collapse over the warm tables."""
        by_leaf: dict[int, list[mckp.GroupedOptions]] = {}
        leaf_ids = np.asarray(batch.domain_ids)
        for leaf in np.unique(leaf_ids):
            ii = np.flatnonzero(leaf_ids == leaf)
            by_leaf[int(leaf)] = mckp.collapse_receivers(
                [batch.names[i] for i in ii],
                [batch.surfaces[i] for i in ii],
                batch.baselines[ii],
                self._group_table,
            )
        return by_leaf

    def allocate_hierarchical(
        self, batch: ReceiverBatch, budget: float, domain_extra: np.ndarray
    ) -> Allocation:
        """One topology-aware round: per-domain capped frontiers + the
        upper-level budget-split DP through the frontier aggregation tree.
        ``domain_extra`` is the per-domain extra-power headroom (preorder
        ids, caps net of committed draw).

        Incremental path (default, sparse solver, engine-sequenced
        batches): the per-leaf grouping is delta-maintained from the
        batch, unchanged leaves reuse their frontier DPs and assembled
        solutions, and a round whose classes, budget and headroom are all
        unchanged returns the cached Allocation (``last_solver = "cache"``)
        — always bit-for-bit the from-scratch solve.  The reference's NACK
        pins come with the fault paths (ROADMAP.md, queue 1, item 5)."""
        if self.topology is None:
            raise ValueError("ecoshift_hier needs a bound PowerTopology")
        if batch.domain_ids is None:
            raise ValueError("receiver batch carries no domain ids")
        batch = self._served_batch(batch)
        incremental = (
            self.incremental
            and self.solver == "sparse"
            and getattr(batch, "seq", 0) != 0
        )
        state = None
        key = None
        if incremental:
            self._grouping.sync(
                batch, np.asarray(batch.domain_ids), self._group_table
            )
            by_leaf = self._grouping.by_scope()
            state = self._hier_state
            key = (
                tuple(
                    (leaf, tuple(sorted(mckp._group_token(g) for g in groups)))
                    for leaf, groups in sorted(by_leaf.items())
                ),
                mckp._qkey(budget),
                np.asarray(domain_extra).tobytes(),
            )
            hit = self._alloc_cache.get(key)
            if hit is not None:
                self.last_domain_spent = hit[1]
                self.last_solver = "cache"
                self.last_device_s = 0.0
                self.last_fallback_reason = ""
                return hit[0]
        else:
            by_leaf = self._grouped_options_by_leaf(batch)
        root = policies_mod.domain_tree(self.topology, domain_extra, by_leaf)
        sol = None
        self.last_device_s = 0.0
        self.last_fallback_reason = ""
        if incremental and self.fused:
            fstate = self._fused_state
            d0 = fstate.stats["device_s"]
            sol = mckp.solve_hierarchical_fused(
                root, budget, state=self._hier_state, fstate=fstate,
                device=self.device,
            )
            self.last_device_s = fstate.stats["device_s"] - d0
            if sol is None:
                self.last_fallback_reason = fstate.stats["fallback_reason"]
        self.last_solver = "fused" if sol is not None else "host"
        if sol is None:
            sol = mckp.solve_hierarchical(
                root,
                budget,
                solver=self.solver,
                unit=self.unit,
                curve_cache=self._agg_curves,
                frontier_cache=self._frontiers,
                state=state,
                device=self.device,
            )
        self.last_domain_spent = sol.domain_spent
        alloc = policies_mod.allocation_from_solution(
            sol, batch.baselines_map(), budget, self.system.grid
        )
        if key is not None:
            self._alloc_cache[key] = (alloc, sol.domain_spent)
        return alloc

    def ingest_telemetry(self, records) -> None:
        if self.predictor is not None:
            self.predictor.observe(records)
            self.predictor.refresh()


@policies_mod.register_controller("ecoshift_online", pure=False)
class EcoShiftOnlineController(EcoShiftController):
    """EcoShift with a telemetry-driven online predictor as surface source.

    Ignores the ``surfaces`` the engine passes: every receiver's surface
    comes from the attached
    :class:`~repro_torch.cluster.predictor.OnlinePredictor` (the population
    prior for cold-start apps).  After each measured round the engine feeds
    the telemetry back via :meth:`ingest_telemetry` and the predictor
    refreshes the apps whose telemetry warrants it.  Invalidation is
    implicit: option tables are keyed by surface identity, and the
    predictor swaps a surface object only on tolerance-exceeding moves.
    Its batches carry ``seq=0`` (:func:`_served_replace`), so every round
    solves from scratch on the host solvers or, with ``solver="pallas"``,
    on the dense (max,+) kernel.
    """

    policy = "ecoshift_online"
    #: the engine leaves ReceiverBatch.surfaces unfilled: every surface
    #: comes from the predictor, and ground truth must not transit here
    serves_own_surfaces = True

    def __init__(
        self,
        system: SystemSpec,
        *,
        predictor=None,
        config: ControllerConfig | None = None,
        solver: str | None = None,
        unit: float | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = (config if config is not None else ControllerConfig()).merged(
            predictor=predictor, solver=solver, unit=unit, device=device
        )
        if cfg.predictor is None:
            raise ValueError("ecoshift_online needs a predictor")
        super().__init__(system, config=cfg)
        #: repro_torch.cluster.predictor.OnlinePredictor (required)
        self.predictor = cfg.predictor

    def allocate(self, receivers, baselines, budget, surfaces=None):
        seen = {
            a.name: self.predictor.surface_for(a.name, a.surface_id)
            for a in receivers
        }
        return super().allocate(receivers, baselines, budget, seen)

    def allocate_grouped(self, batch: ReceiverBatch, budget: float):
        served = [
            self.predictor.surface_for(name, sid)
            for name, sid in zip(batch.names, batch.surface_ids)
        ]
        return super().allocate_grouped(_served_replace(batch, served), budget)

    def ingest_telemetry(self, records) -> None:
        self.predictor.observe(records)
        self.predictor.refresh()


@policies_mod.register_controller("oracle")
class OracleController(_OptionCachingController):
    """Exhaustive/DP optimum on true surfaces (``sees_truth``); solves on
    the host (``device`` is accepted so every controller builds alike)."""

    policy = "oracle"
    sees_truth = True
    supports_grouped = True

    def __init__(
        self,
        system: SystemSpec,
        *,
        exhaustive: bool | None = None,
        config: ControllerConfig | None = None,
        device=None,
    ):
        super().__init__(system)
        cfg = (config if config is not None else ControllerConfig()).merged(
            exhaustive=exhaustive
        )
        self.config = cfg
        #: None = auto (brute force iff <= 10 receivers)
        self.exhaustive = cfg.exhaustive

    def _brute(self, n: int) -> bool:
        return n <= 10 if self.exhaustive is None else self.exhaustive

    def allocate(self, receivers, baselines, budget, surfaces):
        options = self._options_for(receivers, baselines, surfaces)
        sol = (
            mckp.brute_force(options, budget)
            if self._brute(len(receivers))
            else mckp.solve_sparse(options, budget)
        )
        return policies_mod.allocation_from_solution(
            sol, baselines, budget, self.system.grid
        )

    def allocate_grouped(self, batch: ReceiverBatch, budget: float) -> Allocation:
        # The reference first re-solves around NACK-pinned receivers; the
        # port has no actuation reports yet, so no pins (ROADMAP.md, queue
        # 1, item 5).
        groups = self._grouped_options_for(batch)
        sol = (
            mckp.brute_force(mckp.expand_groups(groups), budget)
            if self._brute(len(batch))
            else mckp.solve_sparse_grouped(
                groups, budget, curve_cache=self._agg_curves
            )
        )
        return policies_mod.allocation_from_solution(
            sol, batch.baselines_map(), budget, self.system.grid
        )


def make_controller(policy: str, system: SystemSpec, **kwargs) -> Controller:
    """Instantiate a registered controller by policy name."""
    return policies_mod.get_controller(policy, system, **kwargs)
