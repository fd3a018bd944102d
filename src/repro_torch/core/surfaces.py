"""Ground-truth power->performance surfaces for the emulator.

The paper measures each application on real Xeon+A100/H100 nodes under a
(cpu_cap, gpu_cap) sweep (§2, Fig. 1-2).  We reproduce the *published
characteristics* of those surfaces analytically (DESIGN.md §9.2):

  T(c, g) = max(T_host(c), T_dev(g)) + rho * min(T_host(c), T_dev(g))
  T_host(c) = host_work / phi_h(c),   T_dev(g) = dev_work / phi_d(g)

where ``phi`` is a saturating DVFS speed curve ``1 - exp(-(p - p0)/tau)``.
This family exhibits exactly the behaviours the paper motivates with:

 * asymmetric CPU/GPU sensitivity (host- vs device-dominant work),
 * diminishing marginal returns in the cap (concave phi),
 * cross-component insensitivity (raising the non-dominant cap does little),
 * full insensitivity when the knee sits below the feasible grid.

The two Fig. 2 anchor applications are fit *exactly* (to float precision) to
the paper's numbers:

 * cfd        : +17.0% for CPU 300->400 W, +7.6% for 400->500 W (CPU-bound)
 * raytracing : +15.5% for GPU 200->300 W, +2.1% for 300->400 W (GPU-bound)

``fit_saturating_curve`` solves for (p0, tau) from those two ratios in closed
form up to a 1-D bisection; tests assert the anchors reproduce to <0.2%.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping

import numpy as np

from repro_torch.core.types import (
    AppSpec,
    CLASS_BOTH,
    CLASS_CPU,
    CLASS_GPU,
    CLASS_NONE,
    SystemSpec,
)

# ---------------------------------------------------------------------------
# Speed curves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpeedCurve:
    """Saturating DVFS speed fraction: phi(p) = 1 - exp(-(p - p0)/tau).

    Clipped below at ``floor`` so surfaces stay finite for caps near/below
    the leakage point p0.  phi is monotonically non-decreasing in p.
    """

    p0: float
    tau: float
    floor: float = 0.05

    def __call__(self, p) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        val = 1.0 - np.exp(-(p - self.p0) / self.tau)
        return np.clip(val, self.floor, 1.0)

    @staticmethod
    def flat() -> "SpeedCurve":
        """A curve saturated everywhere inside any realistic grid."""
        return SpeedCurve(p0=-1e9, tau=1.0)


def fit_saturating_curve(
    p_lo: float,
    p_mid: float,
    p_hi: float,
    gain_lo_mid: float,
    gain_mid_hi: float,
) -> SpeedCurve:
    """Fit (p0, tau) so a component-dominated app shows the given gains.

    ``gain_lo_mid`` is the relative runtime reduction when the dominant cap
    moves p_lo -> p_mid (e.g. 0.17 for cfd CPU 300->400), and likewise for
    p_mid -> p_hi.  For a dominated app T ~ 1/phi, so the gains pin the
    ratios r1 = phi(mid)/phi(lo) and r2 = phi(hi)/phi(mid).  With
    u = exp(-(p_hi - p_mid)/tau) (assuming uniform spacing) both ratios are
    rational in (u, a) and we bisect on u.
    """
    if not np.isclose(p_mid - p_lo, p_hi - p_mid):
        raise ValueError("fit assumes uniformly spaced anchor powers")
    d = p_mid - p_lo
    r1 = 1.0 / (1.0 - gain_lo_mid)
    r2 = 1.0 / (1.0 - gain_mid_hi)

    def resid(u: float) -> float:
        # a = exp(-(p_lo - p0)/tau); two expressions for a must agree.
        a1 = (r1 - 1.0) / (r1 - u)
        a2 = (r2 - 1.0) / (u * (r2 - u))
        return a1 - a2

    lo, hi = 1e-6, 1.0 - 1e-6
    flo = resid(lo)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        fmid = resid(mid)
        if np.sign(fmid) == np.sign(flo):
            lo, flo = mid, fmid
        else:
            hi = mid
    u = 0.5 * (lo + hi)
    tau = -d / np.log(u)
    a = (r1 - 1.0) / (r1 - u)
    p0 = p_lo + tau * np.log(a)
    return SpeedCurve(p0=float(p0), tau=float(tau))


# ---------------------------------------------------------------------------
# Surfaces
# ---------------------------------------------------------------------------


class PowerSurface:
    """Interface: continuous runtime + power-draw model over cap pairs."""

    def runtime(self, c, g) -> np.ndarray:  # pragma: no cover - interface
        raise NotImplementedError

    def power_draw(self, c, g) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError  # pragma: no cover - interface

    # Convenience -----------------------------------------------------------
    def improvement(self, base: tuple[float, float], c, g) -> np.ndarray:
        """Relative runtime reduction I(c,g) vs baseline caps (§3.2.1)."""
        t0 = self.runtime(base[0], base[1])
        return (t0 - self.runtime(c, g)) / t0


@dataclasses.dataclass(frozen=True)
class AnalyticSurface(PowerSurface):
    host_work: float
    dev_work: float
    phi_h: SpeedCurve
    phi_d: SpeedCurve
    #: non-overlapped coupling fraction in [0, ~0.4)
    rho: float = 0.1
    #: natural (uncapped) component draws, for donor detection
    natural_cpu: float = 1e9
    natural_gpu: float = 1e9

    def runtime(self, c, g) -> np.ndarray:
        th = self.host_work / self.phi_h(c)
        td = self.dev_work / self.phi_d(g)
        return np.maximum(th, td) + self.rho * np.minimum(th, td)

    def power_draw(self, c, g) -> tuple[np.ndarray, np.ndarray]:
        c = np.asarray(c, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        return np.minimum(c, self.natural_cpu), np.minimum(g, self.natural_gpu)


@dataclasses.dataclass(frozen=True)
class TabulatedSurface(PowerSurface):
    """Bilinear interpolation over a measured/predicted (c, g) table.

    Used for (a) NCF-predicted surfaces handed to the allocator and (b)
    roofline-derived surfaces of the assigned architectures (surfaces built
    from compiled-HLO cost analysis; the roofline layer is not ported yet).
    """

    cpu_levels: np.ndarray
    gpu_levels: np.ndarray
    #: runtime[i, j] at (cpu_levels[i], gpu_levels[j])
    table: np.ndarray
    natural_cpu: float = 1e9
    natural_gpu: float = 1e9

    def runtime(self, c, g) -> np.ndarray:
        c = np.clip(np.asarray(c, np.float64), self.cpu_levels[0], self.cpu_levels[-1])
        g = np.clip(np.asarray(g, np.float64), self.gpu_levels[0], self.gpu_levels[-1])
        ci = np.clip(np.searchsorted(self.cpu_levels, c) - 1, 0, len(self.cpu_levels) - 2)
        gi = np.clip(np.searchsorted(self.gpu_levels, g) - 1, 0, len(self.gpu_levels) - 2)
        c0, c1 = self.cpu_levels[ci], self.cpu_levels[ci + 1]
        g0, g1 = self.gpu_levels[gi], self.gpu_levels[gi + 1]
        wc = np.where(c1 > c0, (c - c0) / np.where(c1 > c0, c1 - c0, 1.0), 0.0)
        wg = np.where(g1 > g0, (g - g0) / np.where(g1 > g0, g1 - g0, 1.0), 0.0)
        t00 = self.table[ci, gi]
        t01 = self.table[ci, gi + 1]
        t10 = self.table[ci + 1, gi]
        t11 = self.table[ci + 1, gi + 1]
        return (
            t00 * (1 - wc) * (1 - wg)
            + t01 * (1 - wc) * wg
            + t10 * wc * (1 - wg)
            + t11 * wc * wg
        )

    def power_draw(self, c, g) -> tuple[np.ndarray, np.ndarray]:
        c = np.asarray(c, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        return np.minimum(c, self.natural_cpu), np.minimum(g, self.natural_gpu)


def tabulate(surface: PowerSurface, system: SystemSpec) -> TabulatedSurface:
    """Sample a surface on a system's full cap grid."""
    cl, gl = system.grid.cpu_levels, system.grid.gpu_levels
    cc, gg = np.meshgrid(cl, gl, indexing="ij")
    nat_c, nat_g = surface.power_draw(1e9, 1e9)
    return TabulatedSurface(
        cpu_levels=cl,
        gpu_levels=gl,
        table=np.asarray(surface.runtime(cc, gg)),
        natural_cpu=float(nat_c),
        natural_gpu=float(nat_g),
    )


# ---------------------------------------------------------------------------
# Paper anchor surfaces (Fig. 2 / Table 2 calibration)
# ---------------------------------------------------------------------------


def _calibrate(
    build,
    anchors: tuple[float, float, float],
    targets: tuple[float, float],
    axis: str,
    fixed: float,
) -> AnalyticSurface:
    """Iteratively refit the dominant curve so *measured* surface gains hit
    the paper's anchors exactly (the cross-component coupling term slightly
    dilutes the pure-1/phi fit; a few multiplicative corrections converge)."""
    p_lo, p_mid, p_hi = anchors
    g1, g2 = targets
    adj1, adj2 = g1, g2
    surf = None
    for _ in range(8):
        curve = fit_saturating_curve(p_lo, p_mid, p_hi, adj1, adj2)
        surf = build(curve)

        def rt(p):
            return float(
                surf.runtime(p, fixed) if axis == "cpu" else surf.runtime(fixed, p)
            )

        t_lo, t_mid, t_hi = rt(p_lo), rt(p_mid), rt(p_hi)
        m1 = (t_lo - t_mid) / t_lo
        m2 = (t_mid - t_hi) / t_mid
        adj1 = float(np.clip(adj1 * g1 / max(m1, 1e-6), 1e-4, 0.9))
        adj2 = float(np.clip(adj2 * g2 / max(m2, 1e-6), 1e-4, 0.9))
    return surf


def cfd_surface() -> AnalyticSurface:
    """CPU-dominated: +17% for CPU 300->400 W, +7.6% for 400->500 W."""

    def build(phi_h: SpeedCurve) -> AnalyticSurface:
        # device work small enough that the host term dominates everywhere,
        # saturated-early device curve so extra GPU power is near-useless.
        return AnalyticSurface(
            host_work=1.0,
            dev_work=0.25,
            phi_h=phi_h,
            phi_d=SpeedCurve(p0=40.0, tau=35.0),
            rho=0.05,
            natural_cpu=520.0,
            natural_gpu=240.0,
        )

    return _calibrate(build, (300.0, 400.0, 500.0), (0.170, 0.076), "cpu", 200.0)


def raytracing_surface() -> AnalyticSurface:
    """GPU-dominated: +15.5% for GPU 200->300 W, +2.1% for 300->400 W."""

    def build(phi_d: SpeedCurve) -> AnalyticSurface:
        return AnalyticSurface(
            host_work=0.2,
            dev_work=1.0,
            phi_h=SpeedCurve(p0=60.0, tau=60.0),
            phi_d=phi_d,
            rho=0.05,
            natural_cpu=330.0,
            natural_gpu=520.0,
        )

    return _calibrate(build, (200.0, 300.0, 400.0), (0.155, 0.021), "gpu", 300.0)


# ---------------------------------------------------------------------------
# Workload suite (Table 1): 40 apps across 4 sensitivity classes
# ---------------------------------------------------------------------------

#: (suite, app, class) following Table 1 of the paper.
TABLE_1: tuple[tuple[str, str, str], ...] = (
    ("altis", "gemm", CLASS_CPU),
    ("altis", "gups", CLASS_NONE),
    ("altis", "maxflops", CLASS_CPU),
    ("altis", "bfs", CLASS_CPU),
    ("altis", "particlefilter_float", CLASS_GPU),
    ("altis", "cfd_double", CLASS_BOTH),
    ("altis", "particlefilter_naive", CLASS_CPU),
    ("altis", "raytracing", CLASS_GPU),
    ("altis", "fdtd2d", CLASS_GPU),
    ("altis", "nw", CLASS_BOTH),
    ("altis", "cfd", CLASS_CPU),
    ("altis", "lavamd", CLASS_CPU),
    ("altis", "sort", CLASS_CPU),
    ("hecbench", "kalman", CLASS_CPU),
    ("hecbench", "stencil3d", CLASS_CPU),
    ("hecbench", "extrema", CLASS_BOTH),
    ("hecbench", "knn", CLASS_CPU),
    ("hecbench", "dropout", CLASS_NONE),
    ("hecbench", "aobench", CLASS_NONE),
    ("hecbench", "zoom", CLASS_CPU),
    ("hecbench", "convolution3D", CLASS_BOTH),
    ("hecbench", "softmax", CLASS_CPU),
    ("hecbench", "chacha20", CLASS_NONE),
    ("hecbench", "zmddft", CLASS_GPU),
    ("hecbench", "residualLayerNorm", CLASS_BOTH),
    ("hecbench", "backgroundSubtract", CLASS_CPU),
    ("mlperf", "UNet", CLASS_BOTH),
    ("mlperf", "BERT", CLASS_GPU),
    ("mlperf", "ResNet50", CLASS_BOTH),
    ("ecp", "sw4lite", CLASS_CPU),
    ("ecp", "XSBench", CLASS_BOTH),
    ("ecp", "Laghos", CLASS_NONE),
    ("ecp", "miniGAN", CLASS_BOTH),
    ("hpc", "GROMACS", CLASS_CPU),
    ("hpc", "LAMMPS", CLASS_CPU),
    ("spec", "lbm", CLASS_GPU),
    ("spec", "cloverleaf", CLASS_CPU),
    ("spec", "tealeaf", CLASS_GPU),
    ("spec", "minisweep", CLASS_NONE),
    ("spec", "pot3d", CLASS_GPU),
)


def _stable_seed(*parts: str) -> int:
    h = hashlib.sha256("/".join(parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


def _random_surface(rng: np.random.Generator, sclass: str, system: SystemSpec) -> AnalyticSurface:
    """Draw a class-consistent surface with randomized parameters.

    Knee placement is expressed relative to the system grid so the same class
    behaves consistently on System 1 (A100 ranges) and System 2 (H100 ranges).
    """
    grid = system.grid
    c_span = grid.cpu_max - grid.cpu_min
    g_span = grid.gpu_max - grid.gpu_min

    def sensitive(span: float, lo: float) -> SpeedCurve:
        # knee inside the grid: p0 below grid min, tau a fraction of span
        p0 = lo - rng.uniform(0.1, 0.6) * span
        tau = rng.uniform(0.30, 0.70) * span
        return SpeedCurve(p0=float(p0), tau=float(tau))

    def saturated(span: float, lo: float) -> SpeedCurve:
        # knee below the grid: nearly flat inside it
        p0 = lo - rng.uniform(2.0, 4.0) * span
        tau = rng.uniform(0.5, 1.0) * span
        return SpeedCurve(p0=float(p0), tau=float(tau))

    rho = float(rng.uniform(0.02, 0.15))
    if sclass == CLASS_CPU:
        hw, dw = 1.0, float(rng.uniform(0.15, 0.5))
        ph = sensitive(c_span, grid.cpu_min)
        pd = saturated(g_span, grid.gpu_min)
        nat = (grid.cpu_max * 1.1, rng.uniform(0.4, 0.8) * grid.gpu_max)
    elif sclass == CLASS_GPU:
        hw, dw = float(rng.uniform(0.15, 0.5)), 1.0
        ph = saturated(c_span, grid.cpu_min)
        pd = sensitive(g_span, grid.gpu_min)
        nat = (rng.uniform(0.4, 0.8) * grid.cpu_max, grid.gpu_max * 1.1)
    elif sclass == CLASS_BOTH:
        hw, dw = 1.0, float(rng.uniform(0.8, 1.2))
        ph = sensitive(c_span, grid.cpu_min)
        pd = sensitive(g_span, grid.gpu_min)
        rho = float(rng.uniform(0.1, 0.35))
        nat = (grid.cpu_max * 1.1, grid.gpu_max * 1.1)
    elif sclass == CLASS_NONE:
        hw, dw = 1.0, float(rng.uniform(0.5, 1.0))
        ph = saturated(c_span, grid.cpu_min)
        pd = saturated(g_span, grid.gpu_min)
        # draws well below even the initial caps -> pure donor
        nat = (
            rng.uniform(0.3, 0.7) * system.init_cpu,
            rng.uniform(0.3, 0.7) * system.init_gpu,
        )
    else:  # pragma: no cover - guarded by AppSpec
        raise ValueError(sclass)
    return AnalyticSurface(
        host_work=hw,
        dev_work=dw,
        phi_h=ph,
        phi_d=pd,
        rho=rho,
        natural_cpu=float(nat[0]),
        natural_gpu=float(nat[1]),
    )


def build_paper_suite(system: SystemSpec) -> tuple[list[AppSpec], dict[str, PowerSurface]]:
    """The 40-app Table-1 suite with class-consistent random surfaces.

    ``cfd`` and ``raytracing`` use the exact Fig.-2-calibrated surfaces on
    System 2 (the H100 system where the paper measured them); on other
    systems they are drawn like the rest of their class.
    """
    apps: list[AppSpec] = []
    surfaces: dict[str, PowerSurface] = {}
    for suite, app, sclass in TABLE_1:
        name = f"{suite}.{app}"
        spec = AppSpec(name=name, sclass=sclass, surface_id=name)
        rng = np.random.default_rng(_stable_seed(system.name, name))
        if app == "cfd" and system.name == "system2-h100":
            surf: PowerSurface = cfd_surface()
        elif app == "raytracing" and system.name == "system2-h100":
            surf = raytracing_surface()
        else:
            surf = _random_surface(rng, sclass, system)
        apps.append(spec)
        surfaces[name] = surf
    return apps, surfaces


def workload_group(
    apps: list[AppSpec], group: str
) -> list[AppSpec]:
    """Paper §5.2 groups: cpu / gpu / both / insensitive / mixed."""
    key = {
        "cpu": CLASS_CPU,
        "gpu": CLASS_GPU,
        "both": CLASS_BOTH,
        "insensitive": CLASS_NONE,
    }
    if group == "mixed":
        return list(apps)
    if group not in key:
        raise ValueError(f"unknown workload group {group!r}")
    return [a for a in apps if a.sclass == key[group]]


def measured_runtime(
    surface: PowerSurface,
    c: float,
    g: float,
    *,
    rng: np.random.Generator,
    noise_sigma: float,
) -> float:
    """One emulated 'execution': surface lookup + multiplicative noise."""
    t = float(surface.runtime(c, g))
    if noise_sigma > 0:
        t *= float(np.exp(rng.normal(0.0, noise_sigma)))
    return t


def surfaces_by_name(
    specs: list[AppSpec], surfaces: Mapping[str, PowerSurface]
) -> dict[str, PowerSurface]:
    return {s.name: surfaces[s.surface_id] for s in specs}
