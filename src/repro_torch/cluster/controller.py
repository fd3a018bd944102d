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

The names are the reference's.

Receding-horizon (MPC) planning: with ``horizon > 1`` and ``eco_factor <
1`` on the sparse solver, the engine feeds a budget outlook each round
(``set_budget_outlook``) and the controller commits, for this round, the
first spend of ``mckp.plan_horizon`` over the cluster's value-vs-spend
frontier (``grouped_frontier`` on the flat path, ``hierarchical_frontier``
on the warm ``HierState``).  A plan that would not restrict the round
leaves the myopic path literally unchanged.

Fault paths: an actuation report (``notify_actuation``) pins NACKed
receivers at their last-confirmed caps with bounded retry backoff; a
pinned round solves the free receivers on a standalone sub-batch
(``_solve_pinned``), so it leaves the incremental and fused paths and runs
on the host sparse solver (or on the dense kernel under ``"pallas"``).
``snapshot``/``restore`` carry the state that changes results (pins, the
predictor's online state); ``crash_reset`` drops every warm cache, the
resident device banks included, and ``save_snapshot``/``load_snapshot``
persist a snapshot atomically in the reference's msgpack layout.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import struct
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
        after every measured round.  Predictor-backed controllers
        (``ecoshift_online``, ``ecoshift_hier`` with a predictor) refresh
        their surfaces here; everyone else ignores it."""

    def reset(self) -> None:
        self.invalidate()

    # -- fault-tolerance hooks ---------------------------------------------

    def notify_actuation(self, report) -> None:
        """Engine hook after a faulted round's actuation settles
        (:class:`repro_torch.cluster.faults.ActuationReport`).  DP
        controllers pin NACKed receivers at their last-confirmed caps with
        bounded retry backoff; the base class ignores it."""

    def snapshot(self) -> dict:
        """Serializable warm-state checkpoint (plain python/numpy values).

        A controller that is ``crash_reset()`` then ``restore(snapshot)``-ed
        produces bit for bit the allocations of the uninterrupted run.
        Warm caches are not serialized: every incremental and fused path
        is bitwise its from-scratch solve, so only state that changes
        results (pins, online-learned predictor state) survives; caches
        and resident device banks rebuild cold."""
        return {"policy": self.policy}

    def restore(self, state: Mapping) -> None:
        """Adopt a :meth:`snapshot`; drops any warm caches accumulated
        since, so restore is self-contained on a warm controller."""
        if state.get("policy") != self.policy:
            raise ValueError(
                f"snapshot of policy {state.get('policy')!r} cannot restore "
                f"a {self.policy!r} controller"
            )

    def crash_reset(self) -> None:
        """A controller process crash: all warm state is gone (restore a
        snapshot afterwards for checkpointed failover)."""
        self.reset()


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

    The defaults are the reference's; an explicit keyword passed to a
    controller's ``__init__`` overrides the field (``merged``).  ``device``
    is where the fused round and the ``"jax"``/``"pallas"`` stages run
    (None = the CUDA card).

    Receding horizon: ``horizon`` is how many rounds of budget forecast
    the controller plans over (1 = myopic, planning off); ``eco_factor`` is
    the fraction of the myopic weighted (CO2 or price) spend the plan may
    use (>= 1 never restricts); ``plan_levels`` / ``plan_grid`` bound the
    horizon DP's candidates a round and its allowance lattice.
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
    #: repro_torch.core.topology.PowerTopology (hier controller; the
    #: engine binds its own when none is given)
    topology: object | None = None
    #: Oracle brute-force toggle (None = auto, <= 10 receivers)
    exhaustive: bool | None = None
    #: receding-horizon plan length in rounds (1 = myopic)
    horizon: int = 1
    #: fraction of the myopic weighted spend the planner may use
    eco_factor: float = 1.0
    #: max frontier candidates per horizon step
    plan_levels: int = 64
    #: allowance-lattice cells of the horizon DP
    plan_grid: int = 2048
    #: LRU bounds of the warm caches (None = the class defaults).  Any
    #: bound >= 1 keeps results bit for bit: an eviction recomputes
    max_group_tables: int | None = None
    max_agg_curves: int | None = None
    max_picks: int | None = None
    max_plans: int | None = None
    max_allocations: int | None = None
    max_frontiers: int | None = None
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

    #: NACK retry policy: after this many consecutive NACKs the controller
    #: stops re-commanding a receiver (the pin holds until an event or
    #: ``invalidate`` touches it) ...
    NACK_MAX_RETRIES = 4
    #: ... and the exponential retry backoff is capped at this many rounds
    NACK_MAX_BACKOFF = 8

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
        #: NACK pin book: name -> {"caps": (c, g) last-confirmed applied,
        #: "fails": consecutive NACKs, "until": round the backoff expires}
        self._pins: dict[str, dict] = {}
        #: round of the latest actuation report (pins apply to the next
        #: round's solve)
        self._pin_round: int = -1

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
            self._pins.clear()
            self._pin_round = -1
        else:
            for n in names:
                self._options.pop(n, None)
                # an event touching a pinned node (failure, phase change)
                # supersedes the pin: the next solve re-commands it
                self._pins.pop(n, None)

    def _apply_cache_bounds(self, cfg: ControllerConfig) -> None:
        """Resize the warm caches to the config's LRU bounds, in place
        (``mckp.HierState`` holds references to the same cache objects)."""
        for cache, bound in (
            (self._group_tables, cfg.max_group_tables),
            (self._agg_curves, cfg.max_agg_curves),
            (self._pick_cache, cfg.max_picks),
            (self._plan_cache, cfg.max_plans),
            (self._alloc_cache, cfg.max_allocations),
        ):
            if bound is not None:
                cache.resize(bound)

    # -- NACK pinning --------------------------------------------------------

    def notify_actuation(self, report) -> None:
        """Pin NACKed receivers at their last-confirmed applied caps with
        exponential retry backoff: the first NACK retries next round, the
        k-th after ``min(2^(k-1), NACK_MAX_BACKOFF)`` rounds, and after
        ``NACK_MAX_RETRIES`` consecutive NACKs the controller stops
        re-commanding the receiver (the pin holds until an event or
        ``invalidate`` touches the node).  While pinned, a receiver's
        command equals its applied caps, so the actuation layer acks it
        trivially; an ack clears the pin only once the backoff has expired
        (``report.round >= until``), which is the retry firing and
        succeeding."""
        r = int(report.round)
        self._pin_round = r
        for nm in report.nacked:
            p = self._pins.get(nm)
            fails = (p["fails"] if p is not None else 0) + 1
            if fails >= self.NACK_MAX_RETRIES:
                until = r + 10**9  # stop retrying: effectively forever
            else:
                until = r + min(2 ** (fails - 1), self.NACK_MAX_BACKOFF)
            applied = report.applied.get(nm)
            caps = (
                (float(applied[0]), float(applied[1]))
                if applied is not None
                else p["caps"]
            )
            self._pins[nm] = {"caps": caps, "fails": fails, "until": until}
        for nm in report.acked:
            p = self._pins.get(nm)
            if p is not None and r >= p["until"]:
                del self._pins[nm]

    def _active_pins(self, batch: ReceiverBatch) -> dict[str, tuple[float, float]]:
        """Pins that constrain this round's solve, among the batch's
        receivers."""
        if not self._pins:
            return {}
        nxt = self._pin_round + 1
        present = set(batch.names)
        return {
            nm: p["caps"]
            for nm, p in self._pins.items()
            if nxt <= p["until"] and nm in present
        }

    def _solve_pinned(
        self,
        batch: ReceiverBatch,
        budget: float,
        pins: Mapping[str, tuple[float, float]],
        domain_extra=None,
    ) -> Allocation:
        """Pinned-class solve: NACKed receivers hold their last-confirmed
        caps; everyone else solves over the remaining budget/headroom.

        The pinned extra is fitted to the current constraints first —
        derated to each domain's headroom (``PowerTopology.derate_factors``)
        and to the total budget — so the merged allocation always
        validates.  The free receivers re-solve through the ordinary
        grouped/hierarchical path on a standalone (seq=0) sub-batch, so
        headroom a pin does not use is redistributed, and the delta
        grouping resyncs from the next engine-sequenced batch."""
        names = batch.names
        pinned_idx = [i for i, nm in enumerate(names) if nm in pins]
        free_idx = [i for i, nm in enumerate(names) if nm not in pins]
        base = np.asarray(batch.baselines, dtype=np.float64)
        pbase = base[pinned_idx]
        pcaps = np.array(
            [pins[names[i]] for i in pinned_idx], dtype=np.float64
        ).reshape(len(pinned_idx), 2)
        # a pin never takes a receiver below its baseline allotment
        pcaps = np.maximum(pcaps, pbase)
        pextra = pcaps.sum(axis=1) - pbase.sum(axis=1)
        topo = getattr(self, "topology", None)
        dom = (
            np.asarray(batch.domain_ids)[pinned_idx]
            if batch.domain_ids is not None and len(pinned_idx)
            else None
        )

        def domain_sums(extra):
            leaf = np.zeros(len(topo), dtype=np.float64)
            leaf += np.bincount(dom, weights=extra, minlength=len(topo))
            return topo.aggregate_leaves(leaf)

        scale = np.ones(len(pinned_idx))
        if domain_extra is not None and dom is not None:
            scale = topo.derate_factors(
                domain_sums(pextra), np.asarray(domain_extra, dtype=np.float64)
            )[dom]
        tot = float((pextra * scale).sum())
        if tot > budget + 1e-12 and tot > 0:
            scale = scale * (float(budget) / tot)
            tot = float((pextra * scale).sum())
        pcaps = pbase + scale[:, None] * (pcaps - pbase)
        pextra = pextra * scale

        free_budget = max(0.0, float(budget) - tot)
        free_extra = None
        if domain_extra is not None:
            free_extra = np.asarray(domain_extra, dtype=np.float64).copy()
            if dom is not None:
                free_extra = np.clip(
                    free_extra - domain_sums(pextra), 0.0, None
                )
        free = None
        if free_idx:
            sub = ReceiverBatch(
                names=[names[i] for i in free_idx],
                surface_ids=[batch.surface_ids[i] for i in free_idx],
                baselines=base[free_idx],
                surfaces=[batch.surfaces[i] for i in free_idx],
                domain_ids=(
                    np.asarray(batch.domain_ids)[free_idx]
                    if batch.domain_ids is not None
                    else None
                ),
                seq=0,
            )
            if domain_extra is not None:
                free = self.allocate_hierarchical(
                    sub, free_budget, free_extra, _skip_pins=True
                )
            else:
                free = self.allocate_grouped(sub, free_budget, _skip_pins=True)
        caps = dict(free.caps) if free is not None else {}
        for k, i in enumerate(pinned_idx):
            caps[names[i]] = (float(pcaps[k, 0]), float(pcaps[k, 1]))
        pinned_spent = float(pextra.sum())
        if domain_extra is not None:
            ds = dict(getattr(self, "last_domain_spent", None) or {})
            if dom is not None:
                for dn, w in zip(topo.names, domain_sums(pextra)):
                    if w:
                        ds[dn] = ds.get(dn, 0.0) + float(w)
            self.last_domain_spent = ds
        self.last_solver = "pinned"
        return Allocation(
            caps=caps,
            spent=(free.spent if free is not None else 0.0) + pinned_spent,
            predicted_improvement=(
                free.predicted_improvement if free is not None else 0.0
            ),
        )

    # -- snapshot / restore --------------------------------------------------

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["pins"] = {
            nm: {
                "caps": [float(p["caps"][0]), float(p["caps"][1])],
                "fails": int(p["fails"]),
                "until": int(p["until"]),
            }
            for nm, p in self._pins.items()
        }
        snap["pin_round"] = int(self._pin_round)
        return snap

    def restore(self, state: Mapping) -> None:
        super().restore(state)
        self.invalidate(None)  # restore is self-contained on a warm ctrl
        self._pins = {
            nm: {
                "caps": (float(p["caps"][0]), float(p["caps"][1])),
                "fails": int(p["fails"]),
                "until": int(p["until"]),
            }
            for nm, p in state.get("pins", {}).items()
        }
        self._pin_round = int(state.get("pin_round", -1))

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
        eco_factor: float | None = None,
        plan_levels: int | None = None,
        plan_grid: int | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(system)
        cfg = (config if config is not None else ControllerConfig()).merged(
            solver=solver, unit=unit, grouped=grouped,
            incremental=incremental, fused=fused, horizon=horizon,
            eco_factor=eco_factor, plan_levels=plan_levels,
            plan_grid=plan_grid, device=device,
        )
        if cfg.solver not in ("sparse", "dense", "jax", "pallas"):
            raise ValueError(f"unknown solver {cfg.solver!r}")
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
        #: receding-horizon planning: active only when horizon > 1 AND
        #: eco_factor < 1 AND the engine fed an outlook (sparse solver)
        self.horizon = int(cfg.horizon)
        self.eco_factor = float(cfg.eco_factor)
        self.plan_levels = int(cfg.plan_levels)
        self.plan_grid = int(cfg.plan_grid)
        #: (caps, weights) forecast fed by the engine, consumed per round
        self._outlook: tuple | None = None
        #: (group tokens, cutoff) -> planning frontier arrays (flat path)
        self._frontier_lru = mckp.LRUCache(32)
        #: budget the planner committed for the last round (None = the
        #: plan did not restrict the round: the myopic path ran verbatim)
        self.last_planned_budget: float | None = None
        #: full per-round spend plan behind last_planned_budget
        self.last_plan: tuple | None = None
        self._apply_cache_bounds(cfg)

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        super().invalidate(names)
        if names is None:
            self._fused_state.clear()
            self._frontier_lru.clear()

    def snapshot(self) -> dict:
        # fused banks / HierState / frontiers rebuild cold after a restore;
        # only the predictor's online-learned state changes allocations
        snap = super().snapshot()
        pred = getattr(self, "predictor", None)
        if pred is not None:
            snap["predictor"] = pred.state_dict()
        return snap

    def restore(self, state: Mapping) -> None:
        super().restore(state)
        pred = getattr(self, "predictor", None)
        if pred is not None and "predictor" in state:
            pred.load_state_dict(state["predictor"])

    def crash_reset(self) -> None:
        super().crash_reset()
        pred = getattr(self, "predictor", None)
        if pred is not None:
            pred.wipe()

    # -- receding-horizon planning -------------------------------------------

    def set_budget_outlook(self, caps, weights=None) -> None:
        """Engine hook: the provider-backed budget forecast for the next
        ``len(caps)`` rounds (``caps[0]`` = this round's budget) plus the
        optional CO2/price weight signal.  Consumed by the next allocate
        call; refreshed by the engine every round."""
        self._outlook = (
            tuple(float(c) for c in caps),
            None if weights is None else tuple(float(w) for w in weights),
        )

    def _plan_pending(self) -> bool:
        return (
            self.horizon > 1
            and self.eco_factor < 1.0
            and self._outlook is not None
            and self.solver == "sparse"
        )

    def _plan_budget(self, budget: float, frontier_fn) -> float:
        """Run the horizon DP over this round's frontier; returns the
        budget to commit for round 0 (== ``budget`` whenever the plan
        would not restrict it: the caller then proceeds on the unchanged
        myopic path)."""
        self.last_planned_budget = None
        self.last_plan = None
        outlook, self._outlook = self._outlook, None
        caps, weights = outlook
        caps = caps[: self.horizon]
        if weights is not None:
            weights = weights[: self.horizon]
        # one frontier serves every horizon cap: states <= any cap are the
        # same whether the DP ran under that cap or under the larger
        # quantized cutoff, so the frontier is keyed drift-invariantly
        cutoff = mckp._curve_cutoff(max(max(caps), float(budget)))
        keys, vals = frontier_fn(cutoff)
        plan = mckp.plan_horizon(
            keys, vals, caps, weights,
            eco_factor=self.eco_factor,
            levels=self.plan_levels,
            grid=self.plan_grid,
        )
        if plan is None:
            return budget
        b_eff = min(float(budget), float(plan[0]))
        if b_eff >= budget - 1e-9:
            return budget
        self.last_planned_budget = b_eff
        self.last_plan = tuple(plan)
        return b_eff

    def _planning_frontier(self, groups, cutoff: float):
        """Warm flat-path planning frontier (grouped super-stage DP end
        states), LRU-keyed by (group identity tokens, cutoff)."""
        key = (
            tuple(sorted(mckp._group_token(g) for g in groups)),
            mckp._qkey(cutoff),
        )
        hit = self._frontier_lru.get(key)
        if hit is None:
            hit = mckp.grouped_frontier(
                groups,
                cutoff,
                curve_cache=self._agg_curves,
                plan_cache=self._plan_cache,
                chain_cache=self._chain_cache,
            )
            self._frontier_lru[key] = hit
        return hit

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

    def allocate_grouped(
        self, batch: ReceiverBatch, budget: float, _skip_pins: bool = False
    ) -> Allocation:
        """Group-collapsed round: receivers sharing (surface identity,
        baseline) solve as one behaviour class; bitwise equal to
        :meth:`allocate` on the same receivers.

        On the incremental path (sparse solver, engine-sequenced batches)
        the grouping follows the batch deltas, the solve reuses the
        content-keyed caches, and a round whose classes and budget are
        unchanged returns the cached Allocation (``last_solver = "cache"``).
        With ``fused=True`` the solve runs on the device; a round the
        fused path declines runs on the host with ``last_solver = "host"``
        and ``last_fallback_reason`` set.  A round with active NACK pins
        runs :meth:`_solve_pinned` (``last_solver = "pinned"``); a round
        with a budget outlook first lets the planner shrink its budget."""
        if not _skip_pins:
            pins = self._active_pins(batch)
            if pins:
                return self._solve_pinned(batch, budget, pins)
        incremental = (
            self.incremental
            and self.solver == "sparse"
            and getattr(batch, "seq", 0) != 0
        )
        if incremental:
            self._grouping.sync(batch, None, self._group_table)
            groups = self._grouping.groups(0)
        else:
            groups = self._grouped_options_for(batch)
        if self._plan_pending():
            budget = self._plan_budget(
                budget, lambda cap: self._planning_frontier(groups, cap)
            )
        if incremental:
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
        topology=None,
        solver: str | None = None,
        unit: float | None = None,
        predictor=None,
        incremental: bool | None = None,
        fused: bool | None = None,
        horizon: int | None = None,
        eco_factor: float | None = None,
        plan_levels: int | None = None,
        plan_grid: int | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = (config if config is not None else ControllerConfig()).merged(
            topology=topology, solver=solver, unit=unit, predictor=predictor,
            incremental=incremental, fused=fused, horizon=horizon,
            eco_factor=eco_factor, plan_levels=plan_levels,
            plan_grid=plan_grid, device=device,
        )
        super().__init__(system, config=cfg)
        #: repro_torch.core.topology.PowerTopology (given here, or bound by
        #: the engine through bind_topology)
        self.topology = cfg.topology
        #: optional OnlinePredictor: serves surfaces, ingests telemetry
        self.predictor = cfg.predictor
        #: (class layout, quantized budget) -> leaf frontier DP arrays
        self._frontiers = mckp.LRUCache(self.MAX_FRONTIERS)
        if cfg.max_frontiers is not None:
            self._frontiers.resize(cfg.max_frontiers)
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

    def allocate_grouped(
        self, batch: ReceiverBatch, budget: float, _skip_pins: bool = False
    ):
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
        self,
        batch: ReceiverBatch,
        budget: float,
        domain_extra: np.ndarray,
        _skip_pins: bool = False,
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
        — always bit-for-bit the from-scratch solve.  Active NACK pins route
        the round through :meth:`_solve_pinned` under the domain headroom;
        with a budget outlook the planner first reads the root frontier
        (``mckp.hierarchical_frontier`` on the warm ``HierState``) and may
        shrink the round's budget."""
        if self.topology is None:
            raise ValueError("ecoshift_hier needs a bound PowerTopology")
        if batch.domain_ids is None:
            raise ValueError("receiver batch carries no domain ids")
        batch = self._served_batch(batch)
        if not _skip_pins:
            pins = self._active_pins(batch)
            if pins:
                self.last_domain_spent = {}
                return self._solve_pinned(
                    batch, budget, pins, domain_extra=domain_extra
                )
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
        else:
            by_leaf = self._grouped_options_by_leaf(batch)
        root = None
        if self._plan_pending():
            # the root frontier under the quantized cutoff serves every
            # horizon cap; the primed leaf frontiers and tree combines are
            # the same warm HierState entries the solve below reuses
            root = policies_mod.domain_tree(self.topology, domain_extra, by_leaf)
            budget = self._plan_budget(
                budget,
                lambda cap: mckp.hierarchical_frontier(
                    root, cap, state=self._hier_state
                ),
            )
        if incremental:
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
        if root is None:
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

    def allocate_grouped(
        self, batch: ReceiverBatch, budget: float, _skip_pins: bool = False
    ):
        served = [
            self.predictor.surface_for(name, sid)
            for name, sid in zip(batch.names, batch.surface_ids)
        ]
        return super().allocate_grouped(
            _served_replace(batch, served), budget, _skip_pins=_skip_pins
        )

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
        self._apply_cache_bounds(cfg)

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

    def allocate_grouped(
        self, batch: ReceiverBatch, budget: float, _skip_pins: bool = False
    ) -> Allocation:
        if not _skip_pins:
            pins = self._active_pins(batch)
            if pins:
                return self._solve_pinned(batch, budget, pins)
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


# ---------------------------------------------------------------------------
# Snapshot persistence
# ---------------------------------------------------------------------------


def _pack(obj):
    """Encode a snapshot tree for msgpack: ndarrays as tagged
    dtype/shape/bytes, tuples and non-str-keyed dicts as tagged lists
    (msgpack has neither).  Inverse of :func:`_unpack`; float64 values
    round-trip exactly, so a file keeps the bit-for-bit restore."""
    if isinstance(obj, np.ndarray):
        return {
            "__nd__": True,
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
            "data": obj.tobytes(),
        }
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, tuple):
        return {"__tup__": [_pack(v) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {k: _pack(v) for k, v in obj.items()}
        return {"__map__": [[_pack(k), _pack(v)] for k, v in obj.items()]}
    return obj


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            return (
                np.frombuffer(obj["data"], dtype=obj["dtype"])
                .reshape(obj["shape"])
                .copy()
            )
        if "__tup__" in obj:
            return tuple(_unpack(v) for v in obj["__tup__"])
        if "__map__" in obj:
            return {_unpack(k): _unpack(v) for k, v in obj["__map__"]}
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    return obj


def _mp_head(out: bytearray, n: int, fix: int, fix_max: int, wide: tuple) -> None:
    """A msgpack length header: the fix form below ``fix_max``, else the
    narrowest of ``wide`` = ((marker, struct code, limit), ...)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for marker, code, limit in wide:
        if n < limit:
            out.append(marker)
            out += struct.pack(">" + code, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _mp_encode(obj, out: bytearray) -> None:
    """msgpack encoding of the subset ``_pack`` yields (nil, bool, int,
    float64, str, bin, array, str-keyed map), byte for byte what
    ``msgpack.packb(obj, use_bin_type=True)`` writes."""
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for marker, code in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
                if obj < 1 << (8 * struct.calcsize(code)):
                    out.append(marker)
                    out += struct.pack(">" + code, obj)
                    return
            raise ValueError(f"integer {obj} too large for msgpack")
        else:
            for marker, code in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
                if obj >= -(1 << (8 * struct.calcsize(code) - 1)):
                    out.append(marker)
                    out += struct.pack(">" + code, obj)
                    return
            raise ValueError(f"integer {obj} too small for msgpack")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _mp_head(out, len(b), 0xA0, 32,
                 ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16), (0xDB, "I", 1 << 32)))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _mp_head(out, len(b), 0, 0,
                 ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16), (0xC6, "I", 1 << 32)))
        out += b
    elif isinstance(obj, list):
        _mp_head(out, len(obj), 0x90, 16, ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32)))
        for v in obj:
            _mp_encode(v, out)
    elif isinstance(obj, dict):
        _mp_head(out, len(obj), 0x80, 16, ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"snapshot map key {k!r} is not a str")
            _mp_encode(k, out)
            _mp_encode(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a snapshot")


#: fixed-width msgpack markers: marker -> (struct code, kind)
_MP_FIXED = {
    0xCC: ("B", "int"), 0xCD: ("H", "int"), 0xCE: ("I", "int"), 0xCF: ("Q", "int"),
    0xD0: ("b", "int"), 0xD1: ("h", "int"), 0xD2: ("i", "int"), 0xD3: ("q", "int"),
    0xCA: ("f", "float"), 0xCB: ("d", "float"),
    0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
    0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
    0xDC: ("H", "array"), 0xDD: ("I", "array"),
    0xDE: ("H", "map"), 0xDF: ("I", "map"),
}


def _mp_decode(buf: bytes, pos: int) -> tuple[object, int]:
    """Decode one msgpack object at ``pos``; returns (object, next pos)."""
    m = buf[pos]
    pos += 1
    if m <= 0x7F:
        return m, pos
    if m >= 0xE0:
        return m - 0x100, pos
    if 0x80 <= m <= 0x8F:
        kind, n = "map", m & 0x0F
    elif 0x90 <= m <= 0x9F:
        kind, n = "array", m & 0x0F
    elif 0xA0 <= m <= 0xBF:
        kind, n = "str", m & 0x1F
    elif m in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[m], pos
    elif m in _MP_FIXED:
        code, kind = _MP_FIXED[m]
        size = struct.calcsize(code)
        (n,) = struct.unpack_from(">" + code, buf, pos)
        pos += size
        if kind in ("int", "float"):
            return n, pos
    else:
        raise ValueError(f"msgpack marker 0x{m:02x} is outside the snapshot format")
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _mp_decode(buf, pos)
            out.append(v)
        return out, pos
    d = {}
    for _ in range(n):
        k, pos = _mp_decode(buf, pos)
        v, pos = _mp_decode(buf, pos)
        d[k] = v
    return d, pos


def save_snapshot(path: str, snap: Mapping) -> None:
    """Persist a ``Controller.snapshot()`` crash-safely: write a sibling
    temp file, flush + fsync, then ``os.replace`` — a crash mid-write
    leaves the previous snapshot intact, never a torn file.  The bytes are
    the reference's (``msgpack.packb(_pack(snap), use_bin_type=True)``),
    written by the port's own encoder."""
    out = bytearray()
    _mp_encode(_pack(dict(snap)), out)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(out)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    """Read a snapshot written by :func:`save_snapshot` (or by the
    reference's) — feed the result to ``Controller.restore``."""
    with open(path, "rb") as f:
        buf = f.read()
    obj, pos = _mp_decode(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - pos} trailing bytes after the snapshot")
    return _unpack(obj)
