"""Multiple-choice-knapsack solvers for reclaimed-power distribution (§3.2.2).

The dense-grid part of ``repro.core.mckp``, ported:

 * ``solve_dense``       — vectorized numpy DP over option costs;
 * ``solve_dense_jax``   — the dense DP as a loop of (max,+) stages on a
                           torch device, one stage per receiver; grouped and
                           budget-batched forms beside it.

The ``backend`` strings keep the reference's names: ``"pallas"`` runs each
stage through the hand-written CUDA kernel (``repro_torch.kernels``) on a
CUDA device and through its plain PyTorch version on the CPU; ``"jax"``
runs the plain PyTorch version on either.  Both compute in float32, as the
reference does under default JAX, and are bitwise equal to it.

The host sparse solvers (``solver="sparse"``, the reference default) and
the hierarchical and fused paths are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.curves import OptionTable, dense_curve, dense_curves_matrix
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

SPARSE_NOT_PORTED = (
    "solver='sparse' (the host sparse MCKP solvers) is not ported yet: "
    "ROADMAP.md, queue 1, item 1; use solver='pallas', 'jax' or 'dense'"
)


@dataclasses.dataclass
class MCKPSolution:
    """Solution of one distribution round."""

    total_value: float  # Σ_i I_i  (N * average improvement)
    spent: float  # watts used out of the budget
    #: per-receiver picks: name -> (cost_watts, value, (c, g))
    picks: dict[str, tuple[float, float, tuple[float, float]]]

    def average_improvement(self) -> float:
        n = len(self.picks)
        return self.total_value / n if n else 0.0


def table_digest(opt: OptionTable) -> tuple:
    """Content identity of an option table (costs, values, caps bytes).

    Receivers whose tables digest equally are interchangeable in any MCKP;
    this is the key behaviour classes merge on.  Memoized on the (frozen,
    content-immutable) table instance.
    """
    d = opt.__dict__.get("_digest")
    if d is None:
        d = (opt.costs.tobytes(), opt.values.tobytes(), opt.caps.tobytes())
        object.__setattr__(opt, "_digest", d)
    return d


def _pick(opt: OptionTable, j: int) -> tuple[float, float, tuple[float, float]]:
    return (
        float(opt.costs[j]),
        float(opt.values[j]),
        (float(opt.caps[j, 0]), float(opt.caps[j, 1])),
    )


# ---------------------------------------------------------------------------
# Behaviour-class grouping
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupedOptions:
    """One behaviour class: a shared option table with its member receivers."""

    table: OptionTable
    members: tuple[str, ...]

    @property
    def m(self) -> int:
        return len(self.members)


def expand_groups(groups: Sequence[GroupedOptions]) -> list[OptionTable]:
    """Ungrouped, name-sorted expansion (the parity reference ordering)."""
    out = [
        dataclasses.replace(g.table, name=name)
        for g in groups
        for name in g.members
    ]
    out.sort(key=lambda o: o.name)
    return out


def collapse_receivers(
    names: Sequence[str],
    surfaces: Sequence,
    baselines: Sequence[tuple[float, float]],
    build_table,
) -> list[GroupedOptions]:
    """Collapse aligned receiver columns into behaviour-class groups.

    Receivers sharing (surface identity, baseline) form one class;
    ``build_table(surface, baseline)`` is called once per class.
    """
    classes: dict[tuple, list] = {}
    for name, surf, base in zip(names, surfaces, baselines):
        key = (id(surf), base[0], base[1])
        slot = classes.get(key)
        if slot is None:
            classes[key] = [surf, (float(base[0]), float(base[1])), [name]]
        else:
            slot[2].append(name)
    return [
        GroupedOptions(
            table=build_table(surf, base), members=tuple(sorted(members))
        )
        for surf, base, members in classes.values()
    ]


def _merge_classes(groups: Sequence[GroupedOptions]) -> list[list]:
    """Merge interchangeable groups (equal table content) into classes:
    ``[table, members, digest]`` triples sorted by min member name."""
    merged: dict[tuple, list] = {}
    for g in groups:
        d = table_digest(g.table)
        slot = merged.get(d)
        if slot is None:
            merged[d] = [g.table, list(g.members), d]
        else:
            slot[1].extend(g.members)
    return sorted(merged.values(), key=lambda s: min(s[1]))


def solve_grouped(
    groups: Sequence[GroupedOptions],
    budget: float,
    *,
    solver: str = "sparse",
    unit: float = 1.0,
    device: str | torch.device | None = None,
) -> MCKPSolution:
    """Solver dispatch for the group-collapsed paths.  ``device`` is where
    the ``"jax"``/``"pallas"`` stages run (None = the CUDA card)."""
    if solver == "sparse":
        raise NotImplementedError(SPARSE_NOT_PORTED)
    if solver == "dense":
        return solve_dense_grouped(groups, budget, unit=unit)
    if solver in ("jax", "pallas"):
        return solve_dense_jax_grouped(
            groups, budget, unit=unit, backend=solver, device=device
        )
    raise ValueError(f"unknown solver {solver!r}")


# ---------------------------------------------------------------------------
# Dense-grid DP (numpy)
# ---------------------------------------------------------------------------


def _stage_maxplus(
    dp: np.ndarray, costs_u: np.ndarray, values: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One (max,+) stage restricted to option costs.

    dp'[b] = max_j dp[b - cost_j] + value_j   (invalid b-cost_j masked)
    Returns (dp', argmax_j) with first-max tie-breaking.
    """
    nb = dp.shape[0]
    b = np.arange(nb)
    idx = b[None, :] - costs_u[:, None]  # [k, nb]
    cand = (
        np.where(idx >= 0, dp[np.clip(idx, 0, nb - 1)], -np.inf)
        + values[:, None]
    )
    a = np.argmax(cand, axis=0)
    return cand[a, b], a.astype(np.int32)


def _unit_costs(table: OptionTable, unit: float, nb: int):
    """(unit costs, values, option indices) of the options under the grid."""
    cu = np.ceil(table.costs / unit - 1e-9).astype(np.int64)
    keep = cu < nb
    return cu[keep], table.values[keep], np.nonzero(keep)[0]


def solve_dense(
    options: Sequence[OptionTable], budget: float, unit: float = 1.0
) -> MCKPSolution:
    """Vectorized dense DP at ``unit``-watt budget granularity."""
    nb = int(np.floor(budget / unit + 1e-9)) + 1
    dp = np.zeros(nb, dtype=np.float64)
    args: list[np.ndarray] = []
    stages = []
    for opt in options:
        cu, vals, kept = _unit_costs(opt, unit, nb)
        dp, arg = _stage_maxplus(dp, cu, vals)
        args.append(arg)
        stages.append((cu, kept))

    b = int(np.argmax(dp))
    total = float(dp[b])
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    for i in range(len(options) - 1, -1, -1):
        cu, kept = stages[i]
        j_local = int(args[i][b])
        picks[options[i].name] = _pick(options[i], int(kept[j_local]))
        b -= int(cu[j_local])
    spent = sum(c for c, _, _ in picks.values())
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


def _grouped_dense_layout(
    groups: Sequence[GroupedOptions], budget: float, unit: float
):
    """Digest-merged stage layout shared by the grouped dense solvers.

    Returns ``(names, stage_gids, tables, f_groups, ch_groups)``: the
    name-sorted receiver order, each receiver's behaviour-class id, and the
    per-class tables / dense curves — densified once per class.
    """
    classes = _merge_classes(groups)
    pairs = sorted(
        (name, cid)
        for cid, (_, members, _) in enumerate(classes)
        for name in members
    )
    names = [p[0] for p in pairs]
    stage_gids = np.array([p[1] for p in pairs], dtype=np.int32)
    tables = [c[0] for c in classes]
    fs, chs = [], []
    for table in tables:
        f, ch = dense_curve(table, budget, unit)
        fs.append(f)
        chs.append(ch)
    return names, stage_gids, tables, np.stack(fs), np.stack(chs)


def solve_dense_grouped(
    groups: Sequence[GroupedOptions], budget: float, unit: float = 1.0
) -> MCKPSolution:
    """Grouped numpy dense DP: per-class cost/value prep, one stage per
    receiver — bitwise identical to ``solve_dense`` on the name-sorted
    ungrouped expansion."""
    nb = int(np.floor(budget / unit + 1e-9)) + 1
    names, stage_gids, tables, _, _ = _grouped_dense_layout(
        groups, budget, unit
    )
    prep = [_unit_costs(table, unit, nb) for table in tables]

    dp = np.zeros(nb, dtype=np.float64)
    args: list[np.ndarray] = []
    for gid in stage_gids:
        cu, vals, _ = prep[gid]
        dp, arg = _stage_maxplus(dp, cu, vals)
        args.append(arg)

    b = int(np.argmax(dp))
    total = float(dp[b])
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    for i in range(len(names) - 1, -1, -1):
        gid = stage_gids[i]
        cu, _, kept = prep[gid]
        j_local = int(args[i][b])
        picks[names[i]] = _pick(tables[gid], int(kept[j_local]))
        b -= int(cu[j_local])
    spent = sum(c for c, _, _ in picks.values())
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


# ---------------------------------------------------------------------------
# Dense-grid DP on a torch device, one (max,+) stage per receiver
# ---------------------------------------------------------------------------


def _curves_on(f: np.ndarray, device: torch.device) -> torch.Tensor:
    """Dense curves as float32 on ``device`` (the reference's jit casts its
    float64 numpy curves to float32 the same way)."""
    return torch.as_tensor(f, dtype=torch.float32, device=device)


def _jax_dp(f_mat: np.ndarray, backend: str, device: torch.device):
    """Forward DP over dense curves f_mat [N, NB]: returns (dp_final [NB],
    argk [N, NB]), argk[i, b] the units granted to receiver i when b units
    are available to receivers 0..i.  ``backend='pallas'`` runs each stage
    through ``ops.maxplus_conv``, anything else through the plain version."""
    conv = kops.maxplus_conv if backend == "pallas" else kref.maxplus_conv
    f = _curves_on(f_mat, device)
    dp = torch.zeros(f.shape[1], dtype=f.dtype, device=device)
    args = []
    for i in range(f.shape[0]):
        dp, arg = conv(dp, f[i])
        args.append(arg)
    return dp, torch.stack(args)


def solve_dense_jax(
    options: Sequence[OptionTable],
    budget: float,
    unit: float = 1.0,
    backend: str = "jax",
    device: str | torch.device | None = None,
) -> MCKPSolution:
    """Dense DP, one (max,+) stage per receiver on ``device`` (None = the
    CUDA card).  ``backend='pallas'`` is the CUDA kernel, ``'jax'`` the
    plain PyTorch version."""
    device = resolve_device(device)
    f_mat, choices = dense_curves_matrix(list(options), budget, unit)
    dp_final, args = _jax_dp(f_mat, backend, device)
    dp_final = dp_final.cpu().numpy()
    args = args.cpu().numpy()  # the one device -> host copy of the backtrack

    b = int(np.argmax(dp_final))
    total = float(dp_final[b])
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    for i in range(len(options) - 1, -1, -1):
        k = int(args[i, b])  # units granted to receiver i
        picks[options[i].name] = _pick(options[i], int(choices[i][k]))
        b -= k
    spent = sum(c for c, _, _ in picks.values())
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


def _jax_dp_gather(
    f_groups: np.ndarray, stage_gids: np.ndarray, backend: str, device: torch.device
):
    """Repeated-stage forward DP: stage i convolves with the curve of class
    ``stage_gids[i]`` from the [G, NB] class matrix — the same convolutions
    in the same order as ``_jax_dp`` on the row-expanded matrix."""
    f = _curves_on(f_groups, device)
    if backend == "pallas":
        gids = torch.as_tensor(stage_gids, dtype=torch.int64, device=device)
        return kops.maxplus_scan(f, gids)
    dp = torch.zeros(f.shape[1], dtype=f.dtype, device=device)
    args = []
    for gid in stage_gids.tolist():
        dp, arg = kref.maxplus_conv(dp, f[gid])
        args.append(arg)
    return dp, torch.stack(args)


def _gather_backtrack(
    layout,
    args: np.ndarray,
    b: int,
    picks: dict[str, tuple[float, float, tuple[float, float]]],
) -> float:
    """Walk a gather scan's argmaxes from ``b`` granted units down to
    per-receiver picks (reverse stage order); returns the watts spent."""
    names, stage_gids, tables, _, ch_groups = layout
    spent = 0.0
    for i in range(len(names) - 1, -1, -1):
        gid = stage_gids[i]
        k = int(args[i, b])  # units granted to receiver i
        picks[names[i]] = _pick(tables[gid], int(ch_groups[gid][k]))
        spent += picks[names[i]][0]
        b -= k
    return spent


def solve_dense_jax_grouped(
    groups: Sequence[GroupedOptions],
    budget: float,
    unit: float = 1.0,
    backend: str = "jax",
    device: str | torch.device | None = None,
) -> MCKPSolution:
    """Grouped dense DP via the repeated-stage gather scan on ``device``.

    Bitwise identical to ``solve_dense_jax`` on the name-sorted ungrouped
    expansion; curves are densified once per behaviour class."""
    device = resolve_device(device)
    layout = _grouped_dense_layout(groups, budget, unit)
    _, stage_gids, _, f_groups, _ = layout
    dp_final, args = _jax_dp_gather(f_groups, stage_gids, backend, device)
    dp_final = dp_final.cpu().numpy()
    args = args.cpu().numpy()  # [N, NB] int32: one copy for the backtrack

    b = int(np.argmax(dp_final))
    total = float(dp_final[b])
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    spent = _gather_backtrack(layout, args, b, picks)
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


def _jax_dp_batch(f_mats: np.ndarray, backend: str, device: torch.device):
    """Forward DP over R independent rounds, f_mats [R, N, NB]: each stage
    is one row-batched (max,+) convolution over all R rounds.  Returns
    (dp_final [R, NB], args [R, N, NB])."""
    conv = (
        kops.maxplus_conv_batched if backend == "pallas"
        else kref.maxplus_conv_batched
    )
    f = _curves_on(f_mats, device).transpose(0, 1).contiguous()  # [N, R, NB]
    dp = torch.zeros(f.shape[1:], dtype=f.dtype, device=device)
    args = []
    for i in range(f.shape[0]):
        dp, arg = conv(dp, f[i])
        args.append(arg)
    return dp, torch.stack(args, dim=1)


def solve_dense_jax_batch(
    rounds: Sequence[Sequence[OptionTable]],
    budgets: Sequence[float],
    unit: float = 1.0,
    backend: str = "jax",
    device: str | torch.device | None = None,
) -> list[MCKPSolution]:
    """Solve R independent dense-DP rounds with one batched stage loop.

    Curves are densified on the widest budget grid; rounds with fewer
    receivers are padded with identity stages (F = [0, -inf, ...]), and
    each round's argmax is restricted to its own budget range, so every
    solution equals its standalone ``solve_dense_jax`` call.
    """
    if len(rounds) != len(budgets):
        raise ValueError("rounds and budgets must have equal length")
    device = resolve_device(device)
    nbs = [int(np.floor(b / unit + 1e-9)) + 1 for b in budgets]
    nb = max(nbs)
    n_max = max(len(r) for r in rounds)
    f_all = np.empty((len(rounds), n_max, nb), dtype=np.float64)
    ch_all = np.zeros((len(rounds), n_max, nb), dtype=np.int32)
    pad_row = np.full(nb, -np.inf)
    pad_row[0] = 0.0
    for r, opts in enumerate(rounds):
        f, ch = dense_curves_matrix(list(opts), (nb - 1) * unit, unit)
        f_all[r, : len(opts)] = f
        ch_all[r, : len(opts)] = ch
        f_all[r, len(opts) :] = pad_row

    dp_final, args = _jax_dp_batch(f_all, backend, device)
    dp_final = dp_final.cpu().numpy()
    args = args.cpu().numpy()

    sols: list[MCKPSolution] = []
    for r, opts in enumerate(rounds):
        b = int(np.argmax(dp_final[r, : nbs[r]]))
        total = float(dp_final[r, b])
        picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
        for i in range(n_max - 1, -1, -1):
            k = int(args[r, i, b])
            if i < len(opts):
                picks[opts[i].name] = _pick(opts[i], int(ch_all[r, i][k]))
            b -= k
        spent = sum(c for c, _, _ in picks.values())
        sols.append(MCKPSolution(total_value=total, spent=spent, picks=picks))
    return sols
