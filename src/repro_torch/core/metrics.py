"""Evaluation metrics (paper §5.3, §6)."""

from __future__ import annotations

import numpy as np

#: two-sided 98% normal quantile (paper reports 98% confidence intervals)
Z_98 = 2.3263478740408408


def jain_index(x: np.ndarray) -> float:
    """Jain's fairness index (Eq. 3): (Σx)² / (n Σx²), in [1/n, 1].

    Degenerate all-zero improvement vectors return 1.0 (perfectly even).
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n == 0:
        return 1.0
    denom = n * float(np.sum(x * x))
    if denom == 0.0:
        return 1.0
    return float(np.sum(x)) ** 2 / denom


def mean_ci98(samples: np.ndarray) -> tuple[float, float, float]:
    """(mean, lo, hi) with a 98% normal-approximation CI over repeats."""
    s = np.asarray(samples, dtype=np.float64)
    m = float(np.mean(s))
    if s.size < 2:
        return m, m, m
    half = Z_98 * float(np.std(s, ddof=1)) / np.sqrt(s.size)
    return m, m - half, m + half


def prediction_accuracy(p_true: np.ndarray, p_pred: np.ndarray) -> np.ndarray:
    """Per-cell accuracy Acc = 1 - |p̂ - p| / p (paper §6.1)."""
    p_true = np.asarray(p_true, dtype=np.float64)
    p_pred = np.asarray(p_pred, dtype=np.float64)
    return 1.0 - np.abs(p_pred - p_true) / np.maximum(np.abs(p_true), 1e-12)


def gap_cdf(gaps_pp: np.ndarray, points: np.ndarray | None = None):
    """CDF of oracle gaps in percentage points (Fig. 10).

    Returns (sorted_gaps, cdf_values) plus summary dict with the paper's
    reported statistics: median, mean, p90, frac within 1/2/3 pp.
    """
    g = np.sort(np.asarray(gaps_pp, dtype=np.float64))
    cdf = np.arange(1, g.size + 1) / g.size
    summary = {
        "median": float(np.median(g)),
        "mean": float(np.mean(g)),
        "p90": float(np.quantile(g, 0.90)),
        "frac_within_1pp": float(np.mean(g <= 1.0)),
        "frac_within_2pp": float(np.mean(g <= 2.0)),
        "frac_within_3pp": float(np.mean(g <= 3.0)),
    }
    return g, cdf, summary


def violin_quantiles(x: np.ndarray) -> dict[str, float]:
    """Distribution summary standing in for the Fig. 9 violins."""
    x = np.asarray(x, dtype=np.float64)
    qs = np.quantile(x, [0.05, 0.25, 0.5, 0.75, 0.95]) if x.size else np.zeros(5)
    return {
        "p05": float(qs[0]),
        "p25": float(qs[1]),
        "median": float(qs[2]),
        "p75": float(qs[3]),
        "p95": float(qs[4]),
        "mean": float(np.mean(x)) if x.size else 0.0,
    }
