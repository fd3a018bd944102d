"""Per-application improvement curves F_i(b) (paper §3.2.2, Eq. 1).

For receiver ``i`` with baseline caps ``(c̄, ḡ)`` we enumerate upgraded cap
pairs on the feasible grid, compute the predicted relative improvement
``I_i(c, g)`` and the extra-power cost ``e = (c - c̄) + (g - ḡ)``, and then

 * keep only the best improvement at each distinct cost (Algorithm 1 l.2-18),
 * prune dominated options (an option is dominated if a cheaper-or-equal
   option achieves >= improvement),
 * optionally densify to a monotone value-vs-budget curve F_i(b) on a 1 W
   (or coarser) budget grid.

The sparse option table is what the faithful Algorithm-1 solver consumes;
the dense curve feeds the vectorized/JAX/Pallas (max,+) DP.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.surfaces import PowerSurface
from repro_torch.core.types import CapGrid


@dataclasses.dataclass(frozen=True)
class OptionTable:
    """Pruned options for one receiver, sorted by increasing cost.

    Always contains the zero-cost option (0 extra power, 0 improvement,
    baseline caps) so a receiver may legally receive nothing.
    """

    name: str
    costs: np.ndarray  # [K] float64, strictly increasing, costs[0] == 0
    values: np.ndarray  # [K] float64, strictly increasing after pruning
    caps: np.ndarray  # [K, 2] the (c, g) pair realizing each option

    def __post_init__(self):
        assert self.costs.shape == self.values.shape
        assert self.caps.shape == (len(self.costs), 2)
        assert self.costs[0] == 0.0

    @property
    def k(self) -> int:
        return len(self.costs)


def build_options(
    name: str,
    surface: PowerSurface,
    baseline: tuple[float, float],
    grid: CapGrid,
    budget: float,
) -> OptionTable:
    """Enumerate + prune the upgraded-cap option set for one receiver.

    Matches Algorithm 1 lines 2-18: for every grid pair with
    ``c >= c̄, g >= ḡ`` and cost ``e <= B`` keep the best improvement at each
    distinct ``e``; then drop options dominated by cheaper ones, producing a
    strictly-increasing (cost, value) staircase.
    """
    c0, g0 = baseline
    pairs = grid.pairs()
    keep = (pairs[:, 0] >= c0 - 1e-9) & (pairs[:, 1] >= g0 - 1e-9)
    pairs = pairs[keep]
    cost = (pairs[:, 0] - c0) + (pairs[:, 1] - g0)
    feas = cost <= budget + 1e-9
    pairs, cost = pairs[feas], cost[feas]
    impr = np.asarray(surface.improvement(baseline, pairs[:, 0], pairs[:, 1]))

    # best improvement at each distinct cost
    order = np.lexsort((-impr, cost))
    pairs, cost, impr = pairs[order], cost[order], impr[order]
    first = np.ones(len(cost), dtype=bool)
    first[1:] = cost[1:] > cost[:-1] + 1e-9
    pairs, cost, impr = pairs[first], cost[first], impr[first]

    # ensure the zero-cost baseline option exists with value exactly 0
    if len(cost) == 0 or cost[0] > 1e-9:
        pairs = np.concatenate([[[c0, g0]], pairs], axis=0)
        cost = np.concatenate([[0.0], cost])
        impr = np.concatenate([[0.0], impr])
    else:
        impr[0] = 0.0
        pairs[0] = (c0, g0)

    # prune dominated: keep only strictly-improving staircase
    keep_idx = [0]
    best = impr[0]
    for j in range(1, len(cost)):
        if impr[j] > best + 1e-12:
            keep_idx.append(j)
            best = impr[j]
    sel = np.array(keep_idx)
    return OptionTable(name=name, costs=cost[sel], values=impr[sel], caps=pairs[sel])


def dense_curve(
    opts: OptionTable, budget: float, unit: float = 1.0
) -> tuple[np.ndarray, np.ndarray]:
    """Densify an option table to F_i(b) on a budget grid of ``unit`` watts.

    Returns ``(F, choice)`` with ``F[b] = max improvement at cost <= b*unit``
    (Eq. 1; monotone non-decreasing) and ``choice[b]`` the index into
    ``opts`` realizing it.  Costs are *rounded up* to the next unit so the
    densified solution never overspends.
    """
    nb = int(np.floor(budget / unit + 1e-9)) + 1
    f = np.zeros(nb, dtype=np.float64)
    choice = np.zeros(nb, dtype=np.int32)
    cost_units = np.ceil(opts.costs / unit - 1e-9).astype(np.int64)
    # scatter the best option onto each occupied grid position: sort by
    # (unit cost asc, value desc, index asc) and keep each position's first
    # row — the first option attaining the position's max value, exactly the
    # strict-improvement sequential update; positions whose max value is
    # <= 0 keep the (0, choice 0) default
    valid = np.nonzero(cost_units < nb)[0]
    if valid.size:
        order = valid[
            np.lexsort((valid, -opts.values[valid], cost_units[valid]))
        ]
        cu_s = cost_units[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = cu_s[1:] != cu_s[:-1]
        take = order[first & (opts.values[order] > 0.0)]
        f[cost_units[take]] = opts.values[take]
        choice[cost_units[take]] = take
    # running max to enforce "cost <= b": a position keeps its own choice iff
    # it attains the running max (ties keep the later index, matching the
    # sequential update which only overwrote on strict decrease)
    run = np.maximum.accumulate(f)
    kept = np.empty(nb, dtype=bool)
    kept[0] = True
    kept[1:] = f[1:] >= run[:-1]
    src = np.maximum.accumulate(np.where(kept, np.arange(nb), 0))
    return run, choice[src]


def dense_curves_matrix(
    options: list[OptionTable], budget: float, unit: float = 1.0
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-receiver dense curves: F [N, B+1], choices [N, B+1].

    Receivers sharing an ``OptionTable`` object (group-collapsed clusters
    replicate one table across a whole behaviour class) densify once; the
    stacked result gathers the shared rows.
    """
    slot_of: dict[int, int] = {}
    inv = np.empty(len(options), dtype=np.int64)
    fs, chs = [], []
    for i, o in enumerate(options):
        slot = slot_of.get(id(o))
        if slot is None:
            slot = len(fs)
            slot_of[id(o)] = slot
            f, ch = dense_curve(o, budget, unit)
            fs.append(f)
            chs.append(ch)
        inv[i] = slot
    return np.stack(fs)[inv], np.stack(chs)[inv]
