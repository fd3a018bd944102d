"""Online profiling: sampling plans + emulated measurement (paper §3.1).

A numpy copy of ``repro.core.profiler``.

EcoShift profiles an unseen application at a handful of representative
(cpu, gpu) cap pairs for a short window.  The plan mixes the feasible-region
corners (pins the surface's dynamic range), the center, and low-discrepancy
interior points (captures curvature/diminishing returns).  Deterministic
given (app, system) so emulation runs are reproducible.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.surfaces import PowerSurface, measured_runtime
from repro_torch.core.types import SystemSpec


def sampling_plan(
    system: SystemSpec,
    n_samples: int = 8,
    *,
    seed: int = 0,
) -> list[tuple[float, float]]:
    """K representative cap pairs on the system grid."""
    grid = system.grid
    cl, gl = grid.cpu_levels, grid.gpu_levels
    plan: list[tuple[float, float]] = [
        (cl[0], gl[0]),
        (cl[-1], gl[-1]),
        (cl[0], gl[-1]),
        (cl[-1], gl[0]),
        (cl[len(cl) // 2], gl[len(gl) // 2]),
    ]
    rng = np.random.default_rng(seed)
    # Halton-style interior fill on grid points
    while len(plan) < n_samples:
        c = cl[int(rng.integers(1, len(cl) - 1))]
        g = gl[int(rng.integers(1, len(gl) - 1))]
        if (c, g) not in plan:
            plan.append((float(c), float(g)))
    return plan[:n_samples]


def profile_app(
    surface: PowerSurface,
    system: SystemSpec,
    *,
    n_samples: int = 8,
    rng: np.random.Generator | None = None,
    seed: int = 0,
) -> dict[tuple[float, float], float]:
    """Emulated online profiling: measure runtime at the planned cap pairs."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    plan = sampling_plan(system, n_samples, seed=seed)
    return {
        (c, g): measured_runtime(
            surface, c, g, rng=rng, noise_sigma=system.noise_sigma
        )
        for (c, g) in plan
    }


def dense_profile(
    surface: PowerSurface,
    system: SystemSpec,
    *,
    rng: np.random.Generator | None = None,
    noise: bool = True,
) -> dict[tuple[float, float], float]:
    """Full-grid sweep (offline characterization for historical apps)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    out = {}
    sigma = system.noise_sigma if noise else 0.0
    for c in system.grid.cpu_levels:
        for g in system.grid.gpu_levels:
            out[(float(c), float(g))] = measured_runtime(
                surface, float(c), float(g), rng=rng, noise_sigma=sigma
            )
    return out
