"""Cluster-wide power-distribution policies (paper §5.1), ported part.

This slice ports the EcoShift policy on the sparse and dense solvers, the
shared allocation assembly and the stateful-controller registry.  The heuristic
baselines (uniform, DPS, MixedAdaptive), the Oracle and the hierarchical
policy come with later slices (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

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


POLICIES: dict[str, PolicyFn] = {"ecoshift": ecoshift}


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
