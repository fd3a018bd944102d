"""Stateful policy controllers for the multi-round cluster engine.

The EcoShift controller on the dense solvers: it caches per-receiver and
per-behaviour-class ``OptionTable``s across rounds (tables are built to
the grid's headroom ceiling, so they are budget-independent and survive a
changing pool) and solves each round with ``solver``:

 * ``"pallas"`` — the dense DP with every (max,+) stage on the hand-written
   CUDA kernel (its plain PyTorch version for a CPU ``device``);
 * ``"jax"`` — the same DP on the plain PyTorch version;
 * ``"dense"`` — the numpy DP.

The names are the reference's.  ``solver="sparse"`` (the reference's and
this config's default, the host sparse solvers, which carry the
incremental path), the fused device round, receding-horizon (MPC) planning, the
hierarchical controller and the fault paths (NACK pins, snapshots) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

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


@dataclasses.dataclass
class ControllerConfig:
    """Construction config of the EcoShift controller.

    The defaults are the reference's.  ``fused=True`` and ``horizon > 1``
    select paths that are not ported yet and raise; the reference's
    ``incremental`` path belongs to the sparse solver, which raises too.
    ``device`` is where the ``"jax"``/``"pallas"`` stages run (None = the
    CUDA card).
    """

    solver: str = "sparse"
    unit: float = 1.0
    grouped: bool = True
    fused: bool = False
    #: receding-horizon plan length in rounds (1 = myopic)
    horizon: int = 1
    device: str | torch.device | None = None

    def merged(self, **overrides) -> "ControllerConfig":
        """Copy with every non-None override applied (an explicit keyword
        beats the config field)."""
        changes = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **changes) if changes else self


class _OptionCachingController(Controller):
    """Warm ``OptionTable`` caches for the DP-based policies.

    Two layers: per-instance tables keyed by name (the ungrouped path), and
    group tables keyed by (surface identity, baseline), one per behaviour
    class.  Keys are identity based, so a straggler or phase change swaps
    the surface object and the stale entry stops matching.  Tables are
    built to the grid headroom ceiling: every solver skips options costing
    more than the round budget.
    """

    #: bound of the group-table cache (oldest entry evicted first; an
    #: eviction only rebuilds a table, it never changes a result)
    MAX_GROUP_TABLES = 512

    def __init__(self, system: SystemSpec):
        super().__init__(system)
        #: name -> (baseline, surface, table); surface compared by identity
        self._options: dict[
            str, tuple[tuple[float, float], PowerSurface, OptionTable]
        ] = {}
        #: (id(surface), baseline) -> (surface, table)
        self._group_tables: dict[tuple, tuple[PowerSurface, OptionTable]] = {}

    def invalidate(self, names: Sequence[str] | None = None) -> None:
        if names is None:
            self._options.clear()
            self._group_tables.clear()
        else:
            for n in names:
                self._options.pop(n, None)

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
        if len(self._group_tables) > self.MAX_GROUP_TABLES:
            del self._group_tables[next(iter(self._group_tables))]
        return table


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
        fused: bool | None = None,
        horizon: int | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(system)
        cfg = (config if config is not None else ControllerConfig()).merged(
            solver=solver, unit=unit, grouped=grouped, fused=fused,
            horizon=horizon, device=device,
        )
        if cfg.solver == "sparse":
            raise NotImplementedError(mckp.SPARSE_NOT_PORTED)
        if cfg.solver not in ("dense", "jax", "pallas"):
            raise ValueError(f"unknown solver {cfg.solver!r}")
        if cfg.fused:
            raise NotImplementedError(
                "fused=True (the device-resident fused round) is not ported "
                "yet: ROADMAP.md, queue 1, item 2"
            )
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
        self.device = resolve_device(cfg.device)

    @property
    def supports_grouped(self) -> bool:  # type: ignore[override]
        return self.grouped

    def _solve(self, options, budget) -> mckp.MCKPSolution:
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
        :meth:`allocate` on the same receivers."""
        groups = mckp.collapse_receivers(
            batch.names, batch.surfaces, batch.baselines, self._group_table
        )
        sol = mckp.solve_grouped(
            groups, budget, solver=self.solver, unit=self.unit,
            device=self.device,
        )
        return policies_mod.allocation_from_solution(
            sol, batch.baselines_map(), budget, self.system.grid
        )

    def allocate_hierarchical(self, batch, budget, domain_extra):
        raise NotImplementedError(
            "hierarchical allocation is not ported yet: ROADMAP.md, queue 1, "
            "item 3"
        )

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


def make_controller(policy: str, system: SystemSpec, **kwargs) -> Controller:
    """Instantiate a registered controller by policy name."""
    return policies_mod.get_controller(policy, system, **kwargs)
