"""Core datatypes for the EcoShift control plane.

The vocabulary follows the paper (§3.2): a *cluster* runs M applications
(jobs) under a cluster-wide budget; applications partition into *donors*
(draw below their cap, contributing to the reclaimed pool) and *receivers*
(can convert extra watts into speedup).  A policy maps a reclaimed budget B
to per-receiver upgraded cap pairs ``(c, g) >= (c_bar, g_bar)``.

On the TPU adaptation (DESIGN.md §2) ``c`` is the *host* power cap and ``g``
is the *chip* power cap; the math is identical, so we keep the paper's (c, g)
naming throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Cap grids and system specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapGrid:
    """Discrete feasible cap grid (inclusive ranges, fixed step)."""

    cpu_min: float
    cpu_max: float
    gpu_min: float
    gpu_max: float
    step: float = 25.0

    @property
    def cpu_levels(self) -> np.ndarray:
        return np.arange(self.cpu_min, self.cpu_max + 0.5 * self.step, self.step)

    @property
    def gpu_levels(self) -> np.ndarray:
        return np.arange(self.gpu_min, self.gpu_max + 0.5 * self.step, self.step)

    def pairs(self) -> np.ndarray:
        """All (c, g) pairs, shape [n_cpu * n_gpu, 2]."""
        c, g = np.meshgrid(self.cpu_levels, self.gpu_levels, indexing="ij")
        return np.stack([c.ravel(), g.ravel()], axis=-1)

    def clamp(self, c: float, g: float) -> tuple[float, float]:
        return (
            float(np.clip(c, self.cpu_min, self.cpu_max)),
            float(np.clip(g, self.gpu_min, self.gpu_max)),
        )

    def snap(self, c: float, g: float) -> tuple[float, float]:
        """Snap a continuous cap pair down onto the grid (never exceeds)."""
        c, g = self.clamp(c, g)
        c = self.cpu_min + np.floor((c - self.cpu_min) / self.step) * self.step
        g = self.gpu_min + np.floor((g - self.gpu_min) / self.step) * self.step
        return float(c), float(g)


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """One of the paper's two evaluation systems (or a TPU pod analogue)."""

    name: str
    grid: CapGrid
    #: default initial (uniform) caps for emulation sweeps
    init_cpu: float
    init_gpu: float
    #: measurement-noise sigma as a fraction of runtime (repeat-to-repeat)
    noise_sigma: float = 0.004


#: Paper System 1: 2x Xeon 8380 + A100-40GB.  Initial caps 140/150 W (Fig. 5).
SYSTEM_1 = SystemSpec(
    name="system1-a100",
    grid=CapGrid(cpu_min=100.0, cpu_max=400.0, gpu_min=100.0, gpu_max=400.0, step=25.0),
    init_cpu=140.0,
    init_gpu=150.0,
)

#: Paper System 2: 2x Xeon 8468 + H100-80GB.  Initial caps 300/300 W (Fig. 7).
SYSTEM_2 = SystemSpec(
    name="system2-h100",
    grid=CapGrid(cpu_min=200.0, cpu_max=500.0, gpu_min=100.0, gpu_max=500.0, step=25.0),
    init_cpu=300.0,
    init_gpu=300.0,
)

#: TPU v5e pod analogue: host power domain + chip power domain (DESIGN.md §2).
SYSTEM_TPU_V5E = SystemSpec(
    name="tpu-v5e-pod",
    grid=CapGrid(cpu_min=150.0, cpu_max=450.0, gpu_min=100.0, gpu_max=250.0, step=10.0),
    init_cpu=250.0,
    init_gpu=170.0,
)

SYSTEMS: Mapping[str, SystemSpec] = {
    s.name: s for s in (SYSTEM_1, SYSTEM_2, SYSTEM_TPU_V5E)
}


# ---------------------------------------------------------------------------
# Applications and allocations
# ---------------------------------------------------------------------------

#: Paper §2 sensitivity classes.
CLASS_CPU = "C"
CLASS_GPU = "G"
CLASS_BOTH = "B"
CLASS_NONE = "N"
SENSITIVITY_CLASSES = (CLASS_CPU, CLASS_GPU, CLASS_BOTH, CLASS_NONE)


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """A job on the cluster: a name, a sensitivity class and a surface id."""

    name: str
    sclass: str
    surface_id: str

    def __post_init__(self):
        if self.sclass not in SENSITIVITY_CLASSES:
            raise ValueError(f"unknown sensitivity class {self.sclass!r}")


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Result of a policy: per-receiver upgraded caps (>= baseline caps)."""

    #: app name -> (cpu_cap, gpu_cap) after distribution
    caps: Mapping[str, tuple[float, float]]
    #: watts actually spent out of the reclaimed budget
    spent: float
    #: policy-predicted average relative improvement (may be NaN for heuristics)
    predicted_improvement: float = float("nan")

    def extra_power(self, baselines: Mapping[str, tuple[float, float]]) -> float:
        tot = 0.0
        for name, (c, g) in self.caps.items():
            c0, g0 = baselines[name]
            tot += (c - c0) + (g - g0)
        return tot


#: canonical set of ``FusedRoundStats.fallback_reason`` values ("" = no
#: fallback), the ones ``core/mckp.py``'s fused round emits.
FUSED_FALLBACK_REASONS = frozenset(
    {"off_lattice", "grid_overflow", "no_feasible_root", "empty"}
)


@dataclasses.dataclass(frozen=True)
class FusedRoundStats:
    """Counters of the device-resident fused round path (DESIGN.md §14/§17).

    Snapshot of a fused controller's warm device state: rounds that ran
    fully on device, host fallbacks (off-lattice keys, oversized grids,
    infeasible roots — structure changes stay fused since the
    capacity-slack banks of §17), cold host rebuilds of the resident
    banks, device-side compactions (layout changes repacked by on-device
    gather instead of a host rebuild), dirty rows written into the
    resident banks, rounds that short-circuited host assembly on an
    unchanged decision vector, the last round's slack occupancy, and
    cumulative seconds inside the device pipeline (ending with its one
    device-to-host copy).
    """

    rounds: int = 0
    fallbacks: int = 0
    #: cold host-side bank builds + full uploads (first fused round of a
    #: shape family; never fired by churn once the banks are resident)
    rebuilds: int = 0
    #: device-side bank repacks: layout changes (leaf set / pad growth /
    #: topology edits) served by a gather of the clean rows plus a
    #: dirty-row write — the round still runs fused (DESIGN.md §17)
    compactions: int = 0
    row_uploads: int = 0
    short_circuits: int = 0
    #: most recent round's occupancy of the capacity-slack bank layout:
    #: max over the padded dims of used/padded (1.0 = slack exhausted,
    #: the next structural growth compacts into bigger tiers)
    slack_utilization: float = 0.0
    device_s: float = 0.0
    #: why the most recent fused attempt fell back to host ("" = it didn't):
    #: "off_lattice" | "grid_overflow" | "no_feasible_root" | "empty"
    #: (the historical "structure_change" fallback is retired — structure
    #: churn patches or compacts the resident banks and stays fused)
    fallback_reason: str = ""

    @property
    def attempts(self) -> int:
        return self.rounds + self.fallbacks

    @property
    def fused_fraction(self) -> float:
        """Share of attempted fused rounds that stayed on device."""
        n = self.attempts
        return self.rounds / n if n else 0.0


@dataclasses.dataclass
class EmulationResult:
    """Outcome of one emulated redistribution round."""

    policy: str
    #: per-app relative runtime reduction vs the no-distribution baseline
    improvements: dict[str, float]
    allocation: Allocation
    budget: float

    @property
    def avg_improvement(self) -> float:
        vals = list(self.improvements.values())
        return float(np.mean(vals)) if vals else 0.0

    @property
    def jain_index(self) -> float:
        from repro_torch.core import metrics

        return metrics.jain_index(np.array(list(self.improvements.values())))


@dataclasses.dataclass(frozen=True, eq=False)
class ReceiverBatch:
    """Columnar receiver view handed to group-collapsing controllers.

    The cluster engine materializes this instead of per-instance AppSpec
    lists: aligned name/surface-id lists, a [n, 2] baseline-caps array and
    one surface *object* per receiver.  Receivers sharing a surface
    identity and baseline collapse into one option table / DP super-stage
    (DESIGN.md §11).

    **Delta contract** (DESIGN.md §13): batches carry a process-globally
    unique monotone ``seq`` (so a controller reused across sims can never
    confuse their chains).  When the engine derived this batch by patching the previous
    one, ``prev_seq`` names it, ``delta`` lists the positions whose
    surface/baseline changed (new receivers included), and ``removed`` the
    instance names no longer present — so an incremental controller whose
    grouping state is warm at ``prev_seq`` applies O(churn) updates.
    ``delta is None`` means "no provable bound": rebuild from scratch.
    """

    names: Sequence[str]
    surface_ids: Sequence[str]
    baselines: np.ndarray  # [n, 2] float64
    surfaces: Sequence  # PowerSurface per receiver, identity-groupable
    #: per-receiver owning-leaf power-domain id (preorder index into the
    #: sim's PowerTopology); None when the cluster has no topology
    domain_ids: np.ndarray | None = None
    #: monotone batch sequence number (0 = standalone batch)
    seq: int = 0
    #: seq of the batch this one was delta-derived from (None = fresh)
    prev_seq: int | None = None
    #: positions changed vs the prev_seq batch; None = unbounded change
    delta: tuple[int, ...] | None = None
    #: names present at prev_seq but absent here
    removed: tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.names)

    def baselines_map(self) -> dict[str, tuple[float, float]]:
        """name -> baseline caps dict, memoized on the (reused) batch."""
        m = self.__dict__.get("_baselines_map")
        if m is None:
            pairs = self.baselines.tolist()
            m = dict(zip(self.names, map(tuple, pairs)))
            object.__setattr__(self, "_baselines_map", m)
        return m


def validate_allocation(
    alloc: Allocation,
    baselines: Mapping[str, tuple[float, float]],
    budget: float,
    grid: CapGrid,
    *,
    atol: float = 1e-6,
) -> None:
    """Invariant checks shared by tests and the emulator.

    1. every allocated cap is >= its baseline (monotonic upgrade model, §6.2)
    2. every cap is inside the feasible grid range
    3. total extra power <= budget
    """
    names = list(alloc.caps.keys())
    if not names:
        if 0.0 > budget + atol:
            raise ValueError(f"allocation spends 0.0 W > budget {budget} W")
        return
    cg = np.array([alloc.caps[nm] for nm in names], dtype=np.float64)
    base = np.array([baselines[nm] for nm in names], dtype=np.float64)
    below = (cg < base - atol).any(axis=1)
    if below.any():
        i = int(np.flatnonzero(below)[0])
        c, g = cg[i]
        c0, g0 = base[i]
        raise ValueError(
            f"{names[i]}: caps ({c},{g}) below baseline ({c0},{g0})"
        )
    bad_c = (cg[:, 0] < grid.cpu_min - atol) | (cg[:, 0] > grid.cpu_max + atol)
    if bad_c.any():
        i = int(np.flatnonzero(bad_c)[0])
        raise ValueError(f"{names[i]}: cpu cap {cg[i, 0]} outside grid")
    bad_g = (cg[:, 1] < grid.gpu_min - atol) | (cg[:, 1] > grid.gpu_max + atol)
    if bad_g.any():
        i = int(np.flatnonzero(bad_g)[0])
        raise ValueError(f"{names[i]}: gpu cap {cg[i, 1]} outside grid")
    extra = float(np.cumsum((cg - base).sum(axis=1))[-1])
    if extra > budget + atol:
        raise ValueError(f"allocation spends {extra} W > budget {budget} W")


def as_receiver_order(receivers: Sequence[AppSpec]) -> list[AppSpec]:
    """Stable deterministic ordering used by DP and brute force alike."""
    return sorted(receivers, key=lambda a: a.name)
