"""Cluster-wide power-distribution policies (paper §5.1).

All policies share one signature and return a validated ``Allocation``:

    policy(receivers, baselines, budget, system, surfaces, ...) -> Allocation

``surfaces`` carries the runtime model the policy is allowed to see:
 * EcoShift receives *predicted* surfaces (NCF) — or true ones when the
   prediction stage is being ablated;
 * the Oracle receives *true* surfaces;
 * DPS / MixedAdaptive only use telemetry-level information (natural power
   draw), never the performance surfaces.

Ported: the baselines (uniform, DPS, MixedAdaptive), EcoShift on the
sparse and dense solvers, the topology-aware EcoShift-Hier, the Oracle,
the shared allocation assembly and the stateful-controller registry.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import curves, mckp
from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import (
    Allocation,
    AppSpec,
    SystemSpec,
    as_receiver_order,
    validate_allocation,
)

PolicyFn = Callable[..., Allocation]


def allocation_from_solution(
    sol: mckp.MCKPSolution,
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    grid,
) -> Allocation:
    """Turn an MCKP solution's picks into a validated ``Allocation`` —
    the shared assembly step of every DP policy and controller."""
    alloc = Allocation(
        caps={name: pick[2] for name, pick in sol.picks.items()},
        spent=sol.spent,
        predicted_improvement=sol.average_improvement(),
    )
    validate_allocation(alloc, baselines, budget, grid)
    return alloc


def _headroom(baselines, name, system) -> tuple[float, float]:
    c0, g0 = baselines[name]
    grid = system.grid
    return grid.cpu_max - c0, grid.gpu_max - g0


# ---------------------------------------------------------------------------
# No-distribution baseline
# ---------------------------------------------------------------------------


def uniform(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface] | None = None,
) -> Allocation:
    """Keep the initial uniform caps (the paper's measurement baseline)."""
    caps = {a.name: baselines[a.name] for a in receivers}
    alloc = Allocation(caps=caps, spent=0.0, predicted_improvement=0.0)
    validate_allocation(alloc, baselines, budget, system.grid)
    return alloc


# ---------------------------------------------------------------------------
# DPS — fair-share redistribution [Ding & Hoffmann, SC'23]
# ---------------------------------------------------------------------------


def dps(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface] | None = None,
) -> Allocation:
    """Fair-share: equal watts per receiver, split evenly CPU/GPU.

    Water-filling handles grid-ceiling clamps: leftover watts from saturated
    receivers/components are re-shared equally among the rest until either
    the budget is gone or everyone is saturated.  (Table 2: two receivers,
    200 W -> each gets 100 W split 50/50 -> caps (+50, +50).)
    """
    order = as_receiver_order(receivers)
    extra = {a.name: [0.0, 0.0] for a in order}
    head = {a.name: list(_headroom(baselines, a.name, system)) for a in order}
    remaining = float(budget)
    for _ in range(64):
        active = [
            a.name for a in order if head[a.name][0] > 1e-9 or head[a.name][1] > 1e-9
        ]
        if not active or remaining <= 1e-9:
            break
        share = remaining / len(active)
        for name in active:
            hc, hg = head[name]
            want_c = want_g = share / 2.0
            # within a receiver, a saturated component's half spills over
            give_c = min(want_c, hc)
            give_g = min(want_g, hg)
            spill = (want_c - give_c) + (want_g - give_g)
            if spill > 0:
                extra_c = min(spill, hc - give_c)
                give_c += extra_c
                give_g += min(spill - extra_c, hg - give_g)
            extra[name][0] += give_c
            extra[name][1] += give_g
            head[name][0] -= give_c
            head[name][1] -= give_g
            remaining -= give_c + give_g
    caps = {}
    for a in order:
        c0, g0 = baselines[a.name]
        caps[a.name] = (c0 + extra[a.name][0], g0 + extra[a.name][1])
    alloc = Allocation(caps=caps, spent=budget - remaining)
    validate_allocation(alloc, baselines, budget, system.grid)
    return alloc


# ---------------------------------------------------------------------------
# MixedAdaptive — demand-proportional [Wilson et al., IPDPS'21]
# ---------------------------------------------------------------------------


def mixed_adaptive(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface],
) -> Allocation:
    """Allocate proportionally to per-component power *demand*.

    Demand is inferred from telemetry: a component pinned at its cap with
    natural draw above it demands (natural - cap) more watts.  The budget is
    split proportionally to demand, capped at each component's demand and
    grid headroom, with proportional water-filling of the remainder.
    """
    order = as_receiver_order(receivers)
    names = [a.name for a in order]
    demand = np.zeros((len(order), 2))
    head = np.zeros((len(order), 2))
    for i, a in enumerate(order):
        c0, g0 = baselines[a.name]
        nat_c, nat_g = surfaces[a.name].power_draw(1e9, 1e9)
        demand[i, 0] = max(0.0, float(nat_c) - c0)
        demand[i, 1] = max(0.0, float(nat_g) - g0)
        head[i] = _headroom(baselines, a.name, system)
    limit = np.minimum(demand, head)

    give = np.zeros_like(demand)
    remaining = float(budget)
    for _ in range(64):
        room = limit - give
        active = (demand > 1e-9) & (room > 1e-9)
        if remaining <= 1e-9 or not active.any():
            break
        w = np.where(active, demand, 0.0)
        w_sum = w.sum()
        if w_sum <= 0:
            break
        inc = np.minimum(remaining * w / w_sum, room)
        give += inc
        remaining -= float(inc.sum())

    caps = {}
    for i, name in enumerate(names):
        c0, g0 = baselines[name]
        caps[name] = (c0 + float(give[i, 0]), g0 + float(give[i, 1]))
    alloc = Allocation(caps=caps, spent=budget - remaining)
    validate_allocation(alloc, baselines, budget, system.grid)
    return alloc


# ---------------------------------------------------------------------------
# EcoShift — predicted-surface MCKP via DP (the paper's contribution)
# ---------------------------------------------------------------------------


def ecoshift(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface],
    *,
    solver: str = "sparse",
    unit: float = 1.0,
    grouped: bool = False,
    device: str | torch.device | None = None,
) -> Allocation:
    """Build per-receiver option curves from the (predicted) surfaces and
    solve the multiple-choice knapsack with the DP of §3.2.2.

    ``solver``: ``"sparse"`` (the host sparse DP, the default),
    ``"pallas"`` (the dense CUDA kernel), ``"jax"`` (its plain PyTorch
    version), both on ``device`` (None = the CUDA card), or ``"dense"``
    (numpy).  ``grouped=True`` collapses
    receivers sharing (surface identity, baseline) into one behaviour
    class, bitwise equal to the ungrouped path.
    """
    order = as_receiver_order(receivers)
    if grouped:
        groups = mckp.collapse_receivers(
            [a.name for a in order],
            [surfaces[a.name] for a in order],
            [baselines[a.name] for a in order],
            lambda surf, base: curves.build_options(
                "class", surf, base, system.grid, budget
            ),
        )
        sol = mckp.solve_grouped(
            groups, budget, solver=solver, unit=unit, device=device
        )
        return allocation_from_solution(sol, baselines, budget, system.grid)
    options = [
        curves.build_options(
            a.name, surfaces[a.name], baselines[a.name], system.grid, budget
        )
        for a in order
    ]
    if solver == "sparse":
        sol = mckp.solve_sparse(options, budget)
    elif solver == "dense":
        sol = mckp.solve_dense(options, budget, unit=unit)
    elif solver in ("jax", "pallas"):
        sol = mckp.solve_dense_jax(
            options, budget, unit=unit, backend=solver, device=device
        )
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return allocation_from_solution(sol, baselines, budget, system.grid)


# ---------------------------------------------------------------------------
# EcoShift-Hier — topology-aware two-level MCKP (DESIGN.md §12)
# ---------------------------------------------------------------------------


def domain_tree(topology, caps, groups_by_leaf) -> mckp.DomainGroups:
    """Mirror a :class:`~repro_torch.core.topology.PowerTopology` into the
    solver's :class:`~repro_torch.core.mckp.DomainGroups` tree.

    ``caps`` is the per-domain extra-power headroom indexed by preorder
    domain id; ``groups_by_leaf`` maps leaf domain id -> its receivers'
    ``GroupedOptions``.  Shared by the pure policy and the controller.
    """

    def build(d):
        i = topology.index[d.name]
        if d.is_leaf:
            return mckp.DomainGroups(
                name=d.name,
                cap=float(caps[i]),
                groups=tuple(groups_by_leaf.get(i, ())),
            )
        return mckp.DomainGroups(
            name=d.name,
            cap=float(caps[i]),
            children=tuple(build(c) for c in d.children),
        )

    return build(topology.root)


def ecoshift_hier(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface],
    *,
    topology,
    node_of: Mapping[str, int],
    domain_extra: Mapping[str, float] | None = None,
    solver: str = "sparse",
    unit: float = 1.0,
    device: str | torch.device | None = None,
) -> Allocation:
    """Topology-aware EcoShift: per-domain capped frontiers + upper-level DP.

    ``topology`` is a :class:`~repro_torch.core.topology.PowerTopology`;
    ``node_of`` maps each receiver instance name to its node id (the
    topology's leaf ranges own node ids, not instance names).
    ``domain_extra`` gives each domain's extra-power headroom in watts (by
    domain name); when omitted it defaults to the round-0 cap minus the
    baseline caps of the domain's receivers — the standalone
    approximation.  The cluster engine always passes the real headroom (cap
    minus all committed draw, donors and dead nodes included).  The dense
    solvers (``"jax"`` / ``"pallas"``) run on ``device`` (None = the CUDA
    card).

    With a single root domain whose cap covers the budget this is
    bit-for-bit the flat ``ecoshift(grouped=True)`` path.
    """
    order = as_receiver_order(receivers)
    leaf_ids = topology.leaf_of([node_of[a.name] for a in order])

    if domain_extra is not None:
        caps = np.array(
            [domain_extra[d.name] for d in topology.domains], dtype=np.float64
        )
    else:
        committed = np.zeros(len(topology), dtype=np.float64)
        for a, leaf in zip(order, leaf_ids):
            c0, g0 = baselines[a.name]
            committed[leaf] += c0 + g0
        caps = topology.cap_at(0) - topology.aggregate_leaves(committed)
        np.clip(caps, 0.0, None, out=caps)

    groups_by_leaf: dict[int, list[mckp.GroupedOptions]] = {}
    for leaf in np.unique(leaf_ids):
        ii = np.flatnonzero(leaf_ids == leaf)
        members = [order[i] for i in ii]
        groups_by_leaf[int(leaf)] = mckp.collapse_receivers(
            [a.name for a in members],
            [surfaces[a.name] for a in members],
            [baselines[a.name] for a in members],
            lambda surf, base: curves.build_options(
                "class", surf, base, system.grid, budget
            ),
        )
    root = domain_tree(topology, caps, groups_by_leaf)
    sol = mckp.solve_hierarchical(
        root, budget, solver=solver, unit=unit, device=device
    )
    return allocation_from_solution(sol, baselines, budget, system.grid)


# ---------------------------------------------------------------------------
# Oracle — exhaustive search on true surfaces (§5.1, §6.3)
# ---------------------------------------------------------------------------


def oracle(
    receivers: Sequence[AppSpec],
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    system: SystemSpec,
    surfaces: Mapping[str, PowerSurface],
    *,
    exhaustive: bool = True,
) -> Allocation:
    """Brute-force optimum over true surfaces.

    ``exhaustive=True`` runs the DFS brute force (tractable for <= ~10 apps
    after per-app pruning, like the paper's §6.3 study); ``False`` uses the
    exact sparse DP — provably identical on discrete option sets, certified
    by tests, and usable at any scale.
    """
    order = as_receiver_order(receivers)
    options = [
        curves.build_options(
            a.name, surfaces[a.name], baselines[a.name], system.grid, budget
        )
        for a in order
    ]
    sol = (
        mckp.brute_force(options, budget)
        if exhaustive
        else mckp.solve_sparse(options, budget)
    )
    return allocation_from_solution(sol, baselines, budget, system.grid)


POLICIES: dict[str, PolicyFn] = {
    "uniform": uniform,
    "dps": dps,
    "mixed_adaptive": mixed_adaptive,
    "ecoshift": ecoshift,
    "ecoshift_hier": ecoshift_hier,
    "oracle": oracle,
}


# ---------------------------------------------------------------------------
# Stateful controllers (repro_torch.cluster.controller)
# ---------------------------------------------------------------------------

#: policy name -> Controller subclass; populated by
#: repro_torch.cluster.controller via @register_controller
CONTROLLERS: dict[str, type] = {}


def register_controller(name: str, *, pure: bool = True):
    """Class decorator: register a stateful controller for ``name``
    (``pure=True`` requires a pure policy of the same name)."""
    if pure and name not in POLICIES:
        raise KeyError(f"controller for unknown policy {name!r}")

    def deco(cls):
        CONTROLLERS[name] = cls
        return cls

    return deco


def get_controller(name: str, system, **kwargs):
    """Instantiate the stateful controller for ``name`` (see CONTROLLERS)."""
    if name not in CONTROLLERS:
        import repro_torch.cluster.controller  # noqa: F401  (populates registry)
    if name not in CONTROLLERS:
        raise KeyError(f"no controller registered for policy {name!r}")
    return CONTROLLERS[name](system, **kwargs)
