"""Multiple-choice-knapsack solvers for reclaimed-power distribution (§3.2.2).

The port of ``repro.core.mckp``.  Four solver families, each bitwise equal
to the reference, and the receding-horizon planner:

 * the host sparse solvers — ``solve_sparse`` (paper Algorithm 1, the dict
   DP) and the group-collapsed ``solve_sparse_grouped`` (binary-split
   aggregate curves, super-stage DP, canonical assembly) with their warm
   caches; numpy, carried over as is.  ``solver="sparse"`` is the default.
 * the hierarchical solvers — ``solve_hierarchical`` over a
   ``DomainGroups`` power-domain tree: each leaf's class DP becomes a
   capped value-vs-spend frontier and sibling frontiers fold through a
   balanced aggregation tree under every domain's cap (``HierState`` keeps
   it warm).  The sparse form is numpy; the dense form (``"jax"`` /
   ``"pallas"``) runs every leaf's scan as one row-batched (max,+)
   convolution a stage on a torch device and combines the frontiers in
   numpy.
 * the fused device round — ``solve_grouped_fused`` (the flat kind) and
   ``solve_hierarchical_fused`` (the ``tree`` and ``leaf_root`` kinds) keep
   padded option banks resident on a torch device (``FusedState``) and run
   every leaf DP in one launch of the sparse-option (max,+) stage kernel
   (``repro_torch.kernels.ops.maxplus_stages_batched``: the CUDA kernel on
   a CUDA device, its plain version on the CPU) in float64, then, for a
   tree, one launch of the same kernel a combine wave.
 * the dense-grid solvers — ``solve_dense`` (numpy) and ``solve_dense_jax``
   (a loop of (max,+) convolution stages on a torch device), with grouped
   and budget-batched forms.  Their ``backend`` strings keep the
   reference's names: ``"pallas"`` runs each stage through the dense CUDA
   kernel on a CUDA device and through its plain version on the CPU;
   ``"jax"`` runs the plain version on either, in float32.
 * receding-horizon (MPC) planning — ``grouped_frontier`` /
   ``hierarchical_frontier`` read the cluster's value-vs-spend frontier off
   the warm caches, and ``plan_horizon`` runs the H-round spend DP over its
   record points (``frontier_records``); numpy, O(H · levels · grid).

Determinism contract (the reference's): receivers with byte-identical
option tables are interchangeable, so ``solve_sparse`` canonicalizes —
identical-table stages exchange their chosen options so costs ascend in
stage order — which is exactly the form the group-collapsed and fused
solvers reproduce.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import time
from collections import OrderedDict
from typing import MutableMapping, Sequence

import numpy as np
import torch

from repro_torch.core.curves import OptionTable, dense_curve, dense_curves_matrix
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class LRUCache(MutableMapping):
    """Bounded mapping with least-recently-used eviction.

    Drop-in for the plain-dict warm caches (aggregate curves, frontiers,
    pick multisets): ``get``/``[]`` refresh recency, inserts beyond
    ``maxsize`` evict the coldest entry.  Keeps long scenarios from growing
    warm state without bound across distinct budgets/digests.
    """

    def __init__(self, maxsize: int = 512):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def __getitem__(self, key):
        val = self._d[key]
        self._d.move_to_end(key)
        return val

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, val):
        self._d[key] = val
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __delitem__(self, key):
        del self._d[key]

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()

    def resize(self, maxsize: int) -> None:
        """Shrink or grow the bound in place, evicting coldest entries as
        needed.  In-place matters: solver state (e.g. ``HierState``) holds
        references to the same cache objects, so resizing must not rebind."""
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


@dataclasses.dataclass
class MCKPSolution:
    """Solution of one distribution round."""

    total_value: float  # Σ_i I_i  (N * average improvement)
    spent: float  # watts used out of the budget
    #: per-receiver picks: name -> (cost_watts, value, (c, g))
    picks: dict[str, tuple[float, float, tuple[float, float]]]
    #: per-domain watts spent (hierarchical solves only)
    domain_spent: dict[str, float] | None = None

    def average_improvement(self) -> float:
        n = len(self.picks)
        return self.total_value / n if n else 0.0


# ---------------------------------------------------------------------------
# Faithful Algorithm 1 (sparse dict DP)
# ---------------------------------------------------------------------------


def _qkey(u: float) -> float:
    """State key: costs within 1e-6 W merge into one DP state.

    Defined as floor(u * 1e6 + 0.5) * 1e-6 so the scalar form and the
    vectorized :func:`_qkey_np` are bitwise identical (same float64 ops) —
    the grouped solver's array DP and the ungrouped dict DP must agree on
    every state key.  For grid-exact watt costs the key equals the sum
    itself, so per-step rounding order cannot diverge between the two.
    """
    return math.floor(u * 1e6 + 0.5) * 1e-6


def _qkey_np(u: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_qkey` (bitwise-identical float64 pipeline)."""
    return np.floor(u * 1e6 + 0.5) * 1e-6


def table_digest(opt: OptionTable) -> tuple:
    """Content identity of an option table (costs, values, caps bytes).

    Receivers whose tables digest equally are *interchangeable* in any MCKP
    — permuting their picks preserves value and feasibility.  This is the
    group key of the collapsed solvers, and the equivalence class within
    which ``solve_sparse`` canonicalizes its assignment.  Note a
    multiplicatively-slowed straggler digests equally to its healthy peers:
    relative improvements are invariant under constant slowdown.

    Memoized on the (frozen, content-immutable) table instance so warm
    controllers pay the bytes conversion once per table, not once per round.
    """
    d = opt.__dict__.get("_digest")
    if d is None:
        d = (opt.costs.tobytes(), opt.values.tobytes(), opt.caps.tobytes())
        object.__setattr__(opt, "_digest", d)
    return d


def _pick_tuples(opt: OptionTable) -> list:
    """Per-option ``(cost, value, (c, g))`` pick tuples, memoized on the
    table — the one representation every solver's ``picks`` dict uses."""
    pt = opt.__dict__.get("_pick_tuples")
    if pt is None:
        pt = [
            (float(c), float(v), (float(cc[0]), float(cc[1])))
            for c, v, cc in zip(opt.costs, opt.values, opt.caps)
        ]
        object.__setattr__(opt, "_pick_tuples", pt)
    return pt


_group_counter = itertools.count(1)


def _group_token(g: "GroupedOptions") -> int:
    """Process-unique identity token of one (immutable) GroupedOptions.

    Incremental controllers reuse group objects across rounds while their
    membership is unchanged, so token tuples are cheap round-over-round
    cache keys for merged-class plans (unlike ``id()``, tokens are never
    reused after garbage collection)."""
    t = g.__dict__.get("_token")
    if t is None:
        t = next(_group_counter)
        object.__setattr__(g, "_token", t)
    return t


def _canonical_solution(
    options: Sequence[OptionTable], js: list[int]
) -> MCKPSolution:
    """Assemble a solution from per-stage option choices in canonical form.

    Identical-table stages (same :func:`table_digest`) exchange their
    chosen options so option indices ascend in stage order, and
    ``total_value`` / ``spent`` are accumulated stage by stage — the one
    deterministic representative of the optimum's permutation class, and
    exactly what :func:`solve_sparse_grouped` reconstructs.
    """
    by_digest: dict[tuple, list[int]] = {}
    for i, opt in enumerate(options):
        by_digest.setdefault(table_digest(opt), []).append(i)
    for idxs in by_digest.values():
        if len(idxs) > 1:
            for i, j in zip(idxs, sorted(js[i] for i in idxs)):
                js[i] = j
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    total = 0.0
    spent = 0.0
    for i, opt in enumerate(options):
        j = js[i]
        picks[opt.name] = (
            float(opt.costs[j]),
            float(opt.values[j]),
            (float(opt.caps[j, 0]), float(opt.caps[j, 1])),
        )
        total += float(opt.values[j])
        spent += float(opt.costs[j])
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


def solve_sparse(options: Sequence[OptionTable], budget: float) -> MCKPSolution:
    """Paper Algorithm 1 with parent-pointer backtracking.

    States are keyed by *used power* (floats straight from the option
    tables — no budget discretization), exactly like the pseudo-code's
    ``DP`` dict.  Costs within 1e-6 W are merged to keep the state count
    equal to the number of distinct achievable sums.  The returned solution
    is canonicalized (see :func:`_canonical_solution`) so interchangeable
    receivers always get their picks in ascending-cost stage order.
    """
    qkey = _qkey
    # DP: used -> (score, parent_used, option_index)
    dp: dict[float, tuple[float, float, int]] = {0.0: (0.0, -1.0, -1)}
    stages: list[dict[float, tuple[float, float, int]]] = []
    for opt in options:
        ndp: dict[float, tuple[float, float, int]] = {}
        for u, (score, _, _) in dp.items():
            for j in range(opt.k):
                e = float(opt.costs[j])
                if u + e > budget + 1e-9:
                    continue
                key = qkey(u + e)
                s = score + float(opt.values[j])
                cur = ndp.get(key)
                if cur is None or s > cur[0]:
                    ndp[key] = (s, u, j)
        stages.append(ndp)
        dp = ndp

    # best end state, then walk parents backwards
    best_u = max(dp, key=lambda u: dp[u][0])
    js: list[int] = [0] * len(options)
    u = best_u
    for i in range(len(options) - 1, -1, -1):
        _, parent, j = stages[i][qkey(u)]
        js[i] = j
        u = parent
    return _canonical_solution(options, js)


def _pick(opt: OptionTable, j: int) -> tuple[float, float, tuple[float, float]]:
    return (
        float(opt.costs[j]),
        float(opt.values[j]),
        (float(opt.caps[j, 0]), float(opt.caps[j, 1])),
    )


# ---------------------------------------------------------------------------
# Group-collapsed sparse DP (bounded MCKP via binary-split multiplicity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupedOptions:
    """One behaviour class: a shared option table with its member receivers.

    All members share the table (same surface identity, baseline and
    slowdown class), so the group acts as a bounded multiple-choice item
    with multiplicity ``m = len(members)``.
    """

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
    ``build_table(surface, baseline)`` is called once per class (a warm
    cache lookup on the controller path, a fresh ``curves.build_options``
    on the pure-policy path).
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


def solve_grouped(
    groups: Sequence[GroupedOptions],
    budget: float,
    *,
    solver: str = "sparse",
    unit: float = 1.0,
    curve_cache: MutableMapping | None = None,
    pick_cache: MutableMapping | None = None,
    plan_cache: MutableMapping | None = None,
    chain_cache: MutableMapping | None = None,
    device: str | torch.device | None = None,
) -> MCKPSolution:
    """Solver dispatch for the group-collapsed paths (see ``solve_*_grouped``).
    ``device`` is where the ``"jax"``/``"pallas"`` stages run (None = the
    CUDA card); the sparse and dense solvers run on the host."""
    if solver == "sparse":
        return solve_sparse_grouped(
            groups,
            budget,
            curve_cache=curve_cache,
            pick_cache=pick_cache,
            plan_cache=plan_cache,
            chain_cache=chain_cache,
        )
    if solver == "dense":
        return solve_dense_grouped(groups, budget, unit=unit)
    if solver in ("jax", "pallas"):
        return solve_dense_jax_grouped(
            groups, budget, unit=unit, backend=solver, device=device
        )
    raise ValueError(f"unknown solver {solver!r}")


def _dedupe_first_max(
    keys: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per distinct key keep the max value — first occurrence on ties.

    Mirrors the dict DP's ``cur is None or s > cur[0]`` update over the
    candidates in array order.  Returns (sorted unique keys, selector into
    the input arrays).
    """
    order = np.lexsort((np.arange(len(keys)), -vals, keys))
    k_sorted = keys[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    sel = order[first]
    return keys[sel], sel


def _micro_int(keys: np.ndarray) -> np.ndarray | None:
    """Exact micro-watt integers of quantized spend keys, or None.

    Every spend key in the sparse solvers is a :func:`_qkey` multiple of
    1e-6, i.e. ``float64(n) * 1e-6`` for an integer ``n`` — so ``n`` is
    recoverable exactly and ``float64(n) * 1e-6`` reproduces the key
    *bitwise*.  Returns None when any key fails the round-trip (non-qkey
    floats), which routes the caller to the generic lexsort path.
    """
    ints = np.round(keys * 1e6).astype(np.int64)
    recon = ints.astype(np.float64) * 1e-6
    if recon.tobytes() != keys.tobytes():
        return None
    return ints


#: int-lattice fast path bound: skip when the dense spend grid would exceed
#: this many states (degenerate tiny-gcd key sets fall back to lexsort)
_INT_LATTICE_MAX_STATES = 1 << 21

#: spend-grid chunk for the [K, chunk] candidate tile of the int path
_INT_LATTICE_CHUNK = 1 << 14


def _maxplus_pair(
    a_keys: np.ndarray,
    a_vals: np.ndarray,
    b_keys: np.ndarray,
    b_vals: np.ndarray,
    budget: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(max,+)-convolve two sparse value-vs-spend curves under ``budget``.

    Returns ``(keys, vals, left_keys, right_keys)``: the deduped combined
    curve (ascending quantized spends, best value each) plus, per state,
    the (a, b) spend split realizing it.  Tie-breaking is the scalar dict
    DP's: among equal (key, value) candidates the smallest a-spend wins
    (first occurrence in (a index, b index) order).

    This is the one convolution primitive behind ``_AggCurve.combine``,
    the super-stage DP and the hierarchical frontier tree.  When both key
    sets sit on a common integer watt lattice (grid-aligned costs — the
    production case) the outer-product + lexsort dedupe collapses to a
    dense gather + argmax over the integer spend grid, bitwise identical
    and ~10x faster; otherwise the generic lexsort path runs.
    """
    if len(a_keys) * len(b_keys) > 2048:
        # the int-lattice setup only pays off past a few thousand candidates
        ia = _micro_int(a_keys)
        ib = _micro_int(b_keys) if ia is not None else None
        if ib is not None and len(ia) and len(ib):
            out = _maxplus_pair_int(
                ia, a_keys, a_vals, ib, b_keys, b_vals, budget
            )
            if out is not None:
                return out
    # generic path: full outer product, feasibility prune, first-max dedupe
    raw = (a_keys[:, None] + b_keys[None, :]).ravel()
    vals = (a_vals[:, None] + b_vals[None, :]).ravel()
    feas = np.flatnonzero(raw <= budget + 1e-9)
    keys, sel = _dedupe_first_max(_qkey_np(raw[feas]), vals[feas])
    sel = feas[sel]
    nb = len(b_keys)
    return keys, vals[sel], a_keys[sel // nb], b_keys[sel % nb]


def _maxplus_pair_int(
    ia: np.ndarray,
    a_keys: np.ndarray,
    a_vals: np.ndarray,
    ib: np.ndarray,
    b_keys: np.ndarray,
    b_vals: np.ndarray,
    budget: float,
) -> tuple | None:
    """Integer-lattice (max,+) pair convolution (see :func:`_maxplus_pair`).

    Spends become indices on the gcd-pitch grid; each output state gathers
    its candidates as ``a_dense[t - b] + b_val`` and an argmax with
    last-maximizer tie-breaking reproduces the dict DP's first-max over
    (a asc, b asc) candidate order (for a fixed sum, ascending a-spend is
    descending b-spend).  Returns None when the grid would be too large.
    """
    g = int(np.gcd(np.gcd.reduce(ia), np.gcd.reduce(ib)))
    if g <= 0:
        # all spends are zero: single state (0, best value pair)
        g = 1
    # largest feasible grid index (micro-watt bound mirrors `<= budget+1e-9`)
    bound = np.floor((budget + 1e-9) * 1e6 / g)
    if not np.isfinite(bound):
        return None
    tmax = min(int(bound), int(ia.max() // g + ib.max() // g))
    if tmax < 0:
        # no feasible state at all (negative budget cannot happen upstream,
        # but keep the generic path authoritative for it)
        return None
    if tmax + 1 > _INT_LATTICE_MAX_STATES:
        return None
    nb = tmax + 1
    iag = ia // g
    ibg = ib // g
    keep_a = np.flatnonzero(iag <= tmax)
    keep_b = np.flatnonzero(ibg <= tmax)
    if not len(keep_a) or not len(keep_b):
        return None
    kmax = int(ibg[keep_b].max())
    # a side densified on the grid, left-padded by kmax so every gather
    # index t - kb + kmax is in-bounds (holes and padding are -inf)
    a_pad = np.full(nb + kmax, -np.inf)
    a_pos = np.zeros(nb, dtype=np.int64)
    a_pad[iag[keep_a] + kmax] = a_vals[keep_a]
    a_pos[iag[keep_a]] = keep_a
    # b options in descending-spend order: a plain row argmax then picks,
    # among ties, the largest b spend == the smallest a spend — the dict
    # DP's first max in (a asc, b asc) candidate order
    kbr = ibg[keep_b][::-1].copy()
    vbr = b_vals[keep_b][::-1].copy()
    k = len(kbr)

    out_vals = np.empty(nb, dtype=np.float64)
    out_jr = np.empty(nb, dtype=np.int64)
    for t0 in range(0, nb, _INT_LATTICE_CHUNK):
        t = np.arange(t0, min(t0 + _INT_LATTICE_CHUNK, nb))
        idx = t[:, None] - kbr[None, :] + kmax  # [chunk, K], all in-bounds
        cand = a_pad[idx]
        cand += vbr[None, :]
        jr = np.argmax(cand, axis=1)
        out_jr[t] = jr
        out_vals[t] = cand[np.arange(len(t)), jr]

    feas = np.flatnonzero(out_vals > -np.inf)
    jr = out_jr[feas]
    ta = feas - kbr[jr]
    keys = ((feas * g).astype(np.float64)) * 1e-6
    return (
        keys,
        out_vals[feas],
        a_keys[a_pos[ta]],
        b_keys[keep_b[k - 1 - jr]],
    )


class _AggCurve:
    """Sparse aggregate curve of ``t`` copies of one option table.

    Columns over the curve's states (ascending spend key): ``keys`` are
    quantized spends, ``vals`` the best achievable value at each.  For a
    leaf curve (t == 1) ``back`` holds option indices; for a combined curve
    ``back_left`` / ``back_right`` hold the (left, right) spend split, so
    :meth:`unwind` can walk the binary-split tree back down to the multiset
    of single-receiver picks.  All convolutions are vectorized outer
    (max,+) products deduped by :func:`_dedupe_first_max` — the same
    candidate order and tie-breaking as the scalar dict DP.
    """

    __slots__ = ("keys", "vals", "back", "back_left", "back_right", "left", "right")

    def __init__(self, keys, vals, back=None, back_left=None, back_right=None,
                 left=None, right=None):
        self.keys: np.ndarray = keys
        self.vals: np.ndarray = vals
        self.back = back
        self.back_left = back_left
        self.back_right = back_right
        self.left: _AggCurve | None = left
        self.right: _AggCurve | None = right

    @staticmethod
    def leaf(table: OptionTable, budget: float) -> "_AggCurve":
        feas = np.flatnonzero(table.costs <= budget + 1e-9)
        keys = _qkey_np(table.costs[feas])
        _, sel = _dedupe_first_max(keys, table.values[feas])
        return _AggCurve(
            keys=keys[sel], vals=table.values[feas][sel], back=feas[sel]
        )

    @staticmethod
    def combine(a: "_AggCurve", b: "_AggCurve", budget: float) -> "_AggCurve":
        keys, vals, left, right = _maxplus_pair(
            a.keys, a.vals, b.keys, b.vals, budget
        )
        return _AggCurve(
            keys=keys,
            vals=vals,
            back_left=left,
            back_right=right,
            left=a,
            right=b,
        )

    def _at(self, spend: float) -> int:
        i = int(np.searchsorted(self.keys, spend))
        if i >= len(self.keys) or self.keys[i] != spend:
            raise KeyError(f"aggregate curve has no state at {spend!r}")
        return i

    def unwind(self, spend: float, out: list[int]) -> None:
        """Collect the option-index multiset realizing ``spend``."""
        i = self._at(spend)
        if self.left is None:
            out.append(int(self.back[i]))
        else:
            self.left.unwind(float(self.back_left[i]), out)
            self.right.unwind(float(self.back_right[i]), out)


def aggregate_curve(
    table: OptionTable, m: int, budget: float,
    chain: list[_AggCurve] | None = None,
) -> _AggCurve:
    """m-fold (max,+) self-convolution of a table's sparse staircase.

    Binary split: O(log m) pairwise convolutions build the doubling chain
    P_1, P_2, P_4, ... and the set bits of ``m`` combine into the final
    curve.  State count stays bounded by the distinct achievable sums
    <= budget, so each convolution is one small vectorized outer product.

    ``chain`` optionally persists the doubling chain across calls (keyed by
    (digest, budget) in ``_class_curves``): the powers are multiplicity-
    independent, so when membership churn shifts a class from m to m', only
    the popcount(m') set-bit combines rerun — not the whole chain.
    """
    if chain is None:
        chain = []
    if not chain:
        chain.append(_AggCurve.leaf(table, budget))
    acc: _AggCurve | None = None
    bit = m
    i = 0
    while bit:
        if i >= len(chain):
            chain.append(_AggCurve.combine(chain[-1], chain[-1], budget))
        if bit & 1:
            acc = (
                chain[i] if acc is None
                else _AggCurve.combine(acc, chain[i], budget)
            )
        bit >>= 1
        i += 1
    assert acc is not None
    return acc


def _merge_classes(groups: Sequence[GroupedOptions]) -> list[list]:
    """Merge interchangeable groups (equal table content) into classes.

    Returns ``[table, members, digest]`` triples sorted by min member name —
    the deterministic class order every grouped/hierarchical solver shares.
    """
    merged: dict[tuple, list] = {}
    for g in groups:
        d = table_digest(g.table)
        slot = merged.get(d)
        if slot is None:
            merged[d] = [g.table, list(g.members), d]
        else:
            slot[1].extend(g.members)
    return sorted(merged.values(), key=lambda s: min(s[1]))


class _LeafPlan:
    """Merged-class layout of one behaviour-class set.

    Precomputes everything about the *stage structure* that is independent
    of budget and spends: the digest-merged classes in canonical order
    (sorted by min member name, members name-sorted within each class), the
    ``layout`` content key of the frontier caches, and the permutation
    taking class-concatenated members to the globally name-sorted order the
    canonical assembly uses.  Plans are cached by the group-token tuple so
    incremental controllers reusing unchanged ``GroupedOptions`` objects
    skip the per-round merge + sorts entirely.
    """

    __slots__ = ("classes", "layout", "names_sorted", "order", "key")

    def __init__(self, classes, layout, names_sorted, order, key):
        self.classes: list[list] = classes
        self.layout: tuple = layout
        self.names_sorted: list[str] = names_sorted
        self.order: np.ndarray = order
        #: group-token tuple when plan-cached (None on ephemeral plans)
        self.key: tuple | None = key


def _leaf_plan(
    groups: Sequence[GroupedOptions],
    plan_cache: MutableMapping | None = None,
) -> _LeafPlan:
    """Build (or fetch) the :class:`_LeafPlan` of a behaviour-class set."""
    key = None
    if plan_cache is not None:
        key = tuple(sorted(_group_token(g) for g in groups))
        hit = plan_cache.get(key)
        if hit is not None:
            return hit
    classes = _merge_classes(groups)
    for slot in classes:
        slot[1].sort()
    concat = [nm for _, members, _ in classes for nm in members]
    if concat:
        arr = np.asarray(concat)
        order = np.argsort(arr, kind="stable")
        names_sorted = arr[order].tolist()
    else:
        order = np.empty(0, dtype=np.int64)
        names_sorted = []
    plan = _LeafPlan(
        classes=classes,
        layout=tuple((d, len(m)) for _, m, d in classes),
        names_sorted=names_sorted,
        order=order,
        key=key,
    )
    if plan_cache is not None:
        plan_cache[key] = plan
    return plan


def _curve_cutoff(budget: float) -> float:
    """Canonical aggregate-curve cutoff: the smallest power-of-two multiple
    of 64 W at or above ``budget``.

    Aggregate curves truncated to any cutoff >= the DP budget produce the
    *same* feasible states, values and backtracked multisets (costs are
    non-negative, so an over-cutoff state can never parent a feasible one,
    and dropping it changes no candidate order among survivors).  Keying
    curves and chains by this quantized cutoff instead of the raw budget
    keeps them warm while per-domain headroom drifts watt-by-watt under
    failures and deratings — the curve caches then miss only on genuine
    class changes, not on accounting noise.
    """
    b = 64.0
    while b < budget:
        b *= 2.0
    return b


def _class_curves(
    classes: Sequence[list],
    budget: float,
    curve_cache: MutableMapping | None,
    chain_cache: MutableMapping | None = None,
) -> tuple[list[_AggCurve], list[tuple]]:
    """m-fold aggregate curve per class, memoized by (digest, m, budget).

    ``chain_cache`` persists the multiplicity-independent doubling chains
    by (digest, budget) — kept apart from ``curve_cache`` because churny
    (digest, m) keys would otherwise evict the far-more-valuable chains.
    Returns the curves plus their content cache keys (the pick-multiset
    cache reuses them)."""
    if chain_cache is None:
        chain_cache = curve_cache
    cutoff = _curve_cutoff(budget)
    qc = _qkey(cutoff)
    curves_: list[_AggCurve] = []
    keys: list[tuple] = []
    for table, members, d in classes:
        key = (d, len(members), qc)
        curve = curve_cache.get(key) if curve_cache is not None else None
        if curve is None:
            chain = None
            if chain_cache is not None:
                # membership churn (m -> m') then reruns only the set-bit
                # combines, never the whole chain
                ckey = (d, "powers", qc)
                chain = chain_cache.get(ckey)
                if chain is None:
                    chain = []
                    chain_cache[ckey] = chain  # type: ignore[index]
            curve = aggregate_curve(table, len(members), cutoff, chain=chain)
            if curve_cache is not None:
                curve_cache[key] = curve  # type: ignore[index]
        curves_.append(curve)
        keys.append(key)
    return curves_, keys


def _superstage_dp(
    stage_curves: Sequence[tuple[np.ndarray, np.ndarray]], budget: float
) -> tuple[np.ndarray, np.ndarray, list]:
    """Sparse DP over (keys, vals) super-stages under ``budget``.

    Each stage is one vectorized outer (max,+) product over
    [states x stage spends].  Stages may be class aggregate curves (grouped
    solve) or whole domain frontiers (hierarchical solve).  Returns the
    final ``(dp_keys, dp_vals, stages)`` where each backtracking stage is a
    (keys, parent spend, stage spend) triple.
    """
    dp_keys = np.zeros(1, dtype=np.float64)
    dp_vals = np.zeros(1, dtype=np.float64)
    stages: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for c_keys, c_vals in stage_curves:
        # keys come back ascending from the dedupe, so the stage arrays
        # are searchsorted-ready as-is
        keys, vals, parents, spends = _maxplus_pair(
            dp_keys, dp_vals, c_keys, c_vals, budget
        )
        stages.append((keys, parents, spends))
        dp_keys = keys
        dp_vals = vals
    return dp_keys, dp_vals, stages


class _IntStages:
    """Backtracking record of one leaf solved by the *batched* integer-
    lattice super-stage DP (:func:`_superstage_dp_batch`).

    Holds, per stage, the dense winner table over the leaf's spend grid
    plus the descending-spend stage key arrays; :meth:`backtrack` walks
    them exactly like :func:`_backtrack_superstages` walks sparse stage
    tuples — same states, same spends, bitwise.
    """

    __slots__ = ("g", "win", "kb_desc", "keys_desc", "nstages")

    def __init__(self, g, win, kb_desc, keys_desc, nstages):
        self.g = g
        self.win = win
        self.kb_desc = kb_desc
        self.keys_desc = keys_desc
        self.nstages = nstages

    def backtrack(self, u: float) -> list[float]:
        t = int(round(u * 1e6)) // self.g
        spends = [0.0] * self.nstages
        for s in range(self.nstages - 1, -1, -1):
            j = int(self.win[s][t])
            spends[s] = float(self.keys_desc[s][j])
            t -= int(self.kb_desc[s][j])
        return spends


def _backtrack_superstages(stages, u: float) -> list[float]:
    """Walk the super-stage DP backwards from end state ``u``: the per-stage
    spends realizing it (stage order)."""
    if isinstance(stages, _IntStages):
        return stages.backtrack(u)
    spends: list[float] = [0.0] * len(stages)
    for i in range(len(stages) - 1, -1, -1):
        keys, parents, spends_stage = stages[i]
        pos = int(np.searchsorted(keys, u))
        spends[i] = float(spends_stage[pos])
        u = float(parents[pos])
    return spends


def _superstage_dp_batch(
    jobs: Sequence[tuple[Sequence[tuple[np.ndarray, np.ndarray]], float]],
) -> list[tuple[np.ndarray, np.ndarray, _IntStages]] | None:
    """Solve many leaves' super-stage DPs in one vectorized pass.

    ``jobs`` is a list of (stage curves, eff budget) pairs — one per dirty
    leaf.  All leaves advance through their stages *together*: stage ``s``
    of every leaf is a single [L, K, NB] gather + argmax on the per-leaf
    integer spend lattice, replacing L x S per-leaf convolution calls with
    S batched numpy ops (the sparse-path analogue of the row-batched
    dense convolution).  Per-leaf results — frontier keys,
    values and backtracking stages — are **bitwise identical** to running
    :func:`_superstage_dp` on each leaf alone: the candidate sets, float64
    adds and (value desc, a-spend asc) tie-breaking are data-parallel
    across leaves, padding rows are exact identities (+0.0), and per-leaf
    feasibility masks mirror the per-stage pruning.  Returns None when any
    leaf's keys leave the integer lattice or the padded grid would be
    degenerate — callers then fall back to the per-leaf path.
    """
    L = len(jobs)
    per_leaf = []
    nb_max = 1
    s_max = 1
    k_max = 1
    for stage_curves, eff in jobs:
        ints = []
        g = 0
        for ck, cv in stage_curves:
            ia = _micro_int(ck)
            if ia is None or not len(ia):
                return None
            ints.append(ia)
            g = int(np.gcd(g, np.gcd.reduce(ia)))
        if g <= 0:
            g = 1
        bound = np.floor((eff + 1e-9) * 1e6 / g)
        if not np.isfinite(bound) or bound < 0:
            return None
        tmax = int(bound)
        if tmax + 1 > _INT_LATTICE_MAX_STATES // max(1, L):
            return None
        nb_max = max(nb_max, tmax + 1)
        s_max = max(s_max, len(stage_curves))
        stages_desc = []
        for ia, (ck, cv) in zip(ints, stage_curves):
            keep = np.flatnonzero(ia // g <= tmax)
            if not len(keep):
                return None
            kb = (ia[keep] // g)[::-1].copy()
            stages_desc.append(
                (kb, cv[keep][::-1].copy(), ck[keep][::-1].copy())
            )
            k_max = max(k_max, len(kb))
        per_leaf.append((g, tmax, stages_desc))

    kmax_glob = 0
    for g, tmax, stages_desc in per_leaf:
        for kb, _, _ in stages_desc:
            kmax_glob = max(kmax_glob, int(kb[0]) if len(kb) else 0)
    if L * nb_max * k_max > _INT_LATTICE_MAX_STATES * 8:
        # the per-stage [L, NB, K] candidate tile would be huge; the
        # per-leaf path (chunked _maxplus_pair_int) handles such grids
        return None

    dp = np.full((L, kmax_glob + nb_max), -np.inf)
    dp[:, kmax_glob] = 0.0
    t_grid = np.arange(nb_max)
    leaf_idx = np.arange(L)[:, None, None]
    results_win: list[np.ndarray] = []
    for s in range(s_max):
        kbr = np.zeros((L, k_max), dtype=np.int64)
        vbr = np.full((L, k_max), -np.inf)
        for li, (g, tmax, stages_desc) in enumerate(per_leaf):
            if s < len(stages_desc):
                kb, vb, _ = stages_desc[s]
                kbr[li, : len(kb)] = kb
                vbr[li, : len(vb)] = vb
            else:
                vbr[li, 0] = 0.0  # identity stage: spend 0, value +0.0
        # [L, NB, K] layout: the options axis is contiguous, so the
        # tie-breaking argmax (first max over descending spends) is a
        # cache-friendly row reduction
        idx = t_grid[None, :, None] - kbr[:, None, :] + kmax_glob
        cand = dp[leaf_idx, idx]
        cand += vbr[:, None, :]
        jr = np.argmax(cand, axis=2)
        out = np.take_along_axis(cand, jr[:, :, None], axis=2)[:, :, 0]
        for li, (g, tmax, _) in enumerate(per_leaf):
            if tmax + 1 < nb_max:
                out[li, tmax + 1 :] = -np.inf
        dp[:, kmax_glob:] = out
        results_win.append(jr.astype(np.int32))

    out_final = dp[:, kmax_glob:]
    results = []
    for li, (g, tmax, stages_desc) in enumerate(per_leaf):
        feas = np.flatnonzero(out_final[li, : tmax + 1] > -np.inf)
        dp_keys = (feas * g).astype(np.float64) * 1e-6
        dp_vals = out_final[li, feas].copy()
        stages = _IntStages(
            g=g,
            win=[results_win[s][li] for s in range(len(stages_desc))],
            kb_desc=[kb for kb, _, _ in stages_desc],
            keys_desc=[ks for _, _, ks in stages_desc],
            nstages=len(stages_desc),
        )
        results.append((dp_keys, dp_vals, stages))
    return results


def _class_picks(
    table: OptionTable,
    curve: _AggCurve,
    curve_key: tuple,
    spend: float,
    pick_cache: MutableMapping | None,
) -> tuple[list, np.ndarray, np.ndarray]:
    """One class's canonical pick column at ``spend``: name-sorted members
    get the option multiset in ascending-cost order.  Returns (pick tuples,
    costs, values) aligned with the class's sorted members — memoized by
    (curve content key, quantized spend) so unchanged classes skip the
    binary-split unwind entirely on warm rounds."""
    pkey = (curve_key, _qkey(spend))
    hit = pick_cache.get(pkey) if pick_cache is not None else None
    if hit is None:
        js: list[int] = []
        curve.unwind(spend, js)
        js.sort()
        pt = _pick_tuples(table)
        hit = ([pt[j] for j in js], table.costs[js], table.values[js])
        if pick_cache is not None:
            pick_cache[pkey] = hit
    return hit


def _assemble_plan(
    plan: _LeafPlan,
    curve_keys: Sequence[tuple],
    curves_: Sequence[_AggCurve],
    spends: Sequence[float],
    pick_cache: MutableMapping | None,
) -> tuple[dict, float, float]:
    """Canonical assembly of one plan's solution: picks dict over the
    name-sorted members plus (total_value, spent) accumulated in that same
    order — bit-for-bit the ungrouped ``solve_sparse`` form (sequential
    float64 adds via cumsum == the scalar left fold)."""
    if not plan.names_sorted:
        return {}, 0.0, 0.0
    tuples_parts: list[list] = []
    costs_parts: list[np.ndarray] = []
    vals_parts: list[np.ndarray] = []
    for (table, _, _), ckey, curve, spend in zip(
        plan.classes, curve_keys, curves_, spends
    ):
        tups, costs, vals = _class_picks(table, curve, ckey, spend, pick_cache)
        tuples_parts.append(tups)
        costs_parts.append(costs)
        vals_parts.append(vals)
    flat_tuples = [t for part in tuples_parts for t in part]
    order = plan.order
    picks = dict(zip(plan.names_sorted, (flat_tuples[i] for i in order)))
    costs = np.concatenate(costs_parts)[order]
    vals = np.concatenate(vals_parts)[order]
    total = float(np.cumsum(vals)[-1])
    spent = float(np.cumsum(costs)[-1])
    return picks, total, spent


def solve_sparse_grouped(
    groups: Sequence[GroupedOptions],
    budget: float,
    *,
    curve_cache: MutableMapping | None = None,
    pick_cache: MutableMapping | None = None,
    plan_cache: MutableMapping | None = None,
    chain_cache: MutableMapping | None = None,
) -> MCKPSolution:
    """Group-collapsed Algorithm 1: one DP super-stage per behaviour class.

    Equivalent to — and bit-for-bit equal with — ``solve_sparse`` on the
    name-sorted ungrouped expansion: groups digesting equally merge first
    (their members are interchangeable), each merged group contributes its
    m-fold aggregate curve as a single DP stage, and the backtracked
    per-group spends unwind into option multisets assigned to name-sorted
    members in ascending-cost order (the sparse solver's canonical form).

    All three caches are optional warm state (mutable mappings, e.g. a
    controller's LRU dicts): ``curve_cache`` memoizes aggregate curves by
    (digest, m, quantized budget), ``pick_cache`` memoizes unwound pick
    multisets by (curve key, quantized spend), and ``plan_cache`` memoizes
    merged-class layouts by group-token tuple — together they make a
    steady-state re-solve cost O(changed classes), not O(cluster).
    """
    plan = _leaf_plan(groups, plan_cache)
    curves_, curve_keys = _class_curves(
        plan.classes, budget, curve_cache, chain_cache
    )
    dp_keys, dp_vals, stages = _superstage_dp(
        [(c.keys, c.vals) for c in curves_], budget
    )
    u = float(dp_keys[int(np.argmax(dp_vals))])
    spends = _backtrack_superstages(stages, u)
    picks, total, spent = _assemble_plan(
        plan, curve_keys, curves_, spends, pick_cache
    )
    return MCKPSolution(total_value=total, spent=spent, picks=picks)


# ---------------------------------------------------------------------------
# Hierarchical (two-level) solve over a power-domain tree (DESIGN.md §12)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DomainGroups:
    """One power domain's slice of an allocation round.

    ``cap`` is the domain's *extra-power headroom* in watts — its physical
    cap net of the draw already committed under it (baselines of member
    receivers, natural draw of member donors; the engine does that
    accounting).  A leaf carries the behaviour-class ``groups`` of its
    member receivers (possibly empty); an internal domain carries
    ``children``.
    """

    name: str
    cap: float
    groups: tuple[GroupedOptions, ...] = ()
    children: tuple["DomainGroups", ...] = ()

    def __post_init__(self):
        if self.groups and self.children:
            raise ValueError(
                f"domain {self.name!r}: groups and children are exclusive"
            )


class HierState:
    """Persistent warm state for (incremental) hierarchical sparse solving.

    Every cache is *content-keyed* — digests + multiplicities + quantized
    budgets for curves/frontiers, content tokens for the aggregation-tree
    combines, group-identity tokens for plans and leaf solutions — so a
    warm re-solve is **bit-for-bit** the from-scratch solve: a cache entry
    is only ever reused for inputs under which it would be recomputed
    identically.  A steady-state round therefore costs O(what changed):

     * an unchanged leaf reuses its frontier DP and its assembled solution;
     * a changed leaf re-runs its class super-stages and re-aggregates
       through the balanced frontier **aggregation tree**, recombining only
       the O(log n_leaves) tree nodes on its root path;
     * unchanged classes inside a dirty leaf still reuse their aggregate
       curves and unwound pick multisets.

    All caches are LRU-bounded so long scenarios with drifting budgets or
    digests cannot grow warm state without bound.
    """

    def __init__(
        self,
        curve_cache: MutableMapping | None = None,
        frontier_cache: MutableMapping | None = None,
        *,
        chain_cache: MutableMapping | None = None,
        pick_cache: MutableMapping | None = None,
        plan_cache: MutableMapping | None = None,
        max_curves: int = 1024,
        max_frontiers: int = 512,
        max_picks: int = 8192,
        max_leaf_solutions: int = 128,
        max_plans: int = 256,
    ):
        self.curve_cache: MutableMapping = (
            LRUCache(max_curves) if curve_cache is None else curve_cache
        )
        #: (digest, budget) -> doubling chain, shielded from (d, m) churn
        self.chain_cache: MutableMapping = (
            LRUCache(512) if chain_cache is None else chain_cache
        )
        self.frontier_cache: MutableMapping = (
            LRUCache(max_frontiers) if frontier_cache is None else frontier_cache
        )
        #: (left token, right token, quantized cap) -> combined frontier
        self.comb_cache: MutableMapping = LRUCache(max_frontiers)
        self.pick_cache: MutableMapping = (
            LRUCache(max_picks) if pick_cache is None else pick_cache
        )
        #: (leaf token, plan key, spends) -> (picks, total, spent)
        self.leaf_sol_cache: MutableMapping = LRUCache(max_leaf_solutions)
        self.plan_cache: MutableMapping = (
            LRUCache(max_plans) if plan_cache is None else plan_cache
        )
        self._tokens: dict = {}
        self._next_token = itertools.count(1)

    def token(self, content) -> int:
        """Intern hashable content to a small process-unique int.

        Tokens are never reused (the counter outlives table resets), so a
        stale cache entry keyed by an old token can never collide with new
        content — it just ages out of its LRU."""
        t = self._tokens.get(content)
        if t is None:
            if len(self._tokens) > (1 << 20):
                self._tokens.clear()
            t = next(self._next_token)
            self._tokens[content] = t
        return t

    def cache_sizes(self) -> dict[str, int]:
        return {
            "curves": len(self.curve_cache),
            "frontiers": len(self.frontier_cache),
            "combines": len(self.comb_cache),
            "picks": len(self.pick_cache),
            "leaf_solutions": len(self.leaf_sol_cache),
            "plans": len(self.plan_cache),
        }

    def clear(self) -> None:
        for c in (
            self.curve_cache,
            self.chain_cache,
            self.frontier_cache,
            self.comb_cache,
            self.pick_cache,
            self.leaf_sol_cache,
            self.plan_cache,
        ):
            c.clear()
        self._tokens.clear()


class _CombNode:
    """One node of the balanced frontier aggregation tree.

    Wrapper nodes (``leaf`` set) adapt a child domain's frontier; internal
    nodes hold a (max,+)-combined frontier with per-state (left, right)
    spend splits for backtracking.  The tree shape is a deterministic
    function of the child count (adjacent pairs, odd tail carried up), so
    content-addressed memoization of each combine makes replacing one
    dirty child cost O(log n_children) convolutions.
    """

    __slots__ = ("keys", "vals", "back_left", "back_right", "left", "right", "leaf")

    def __init__(self, keys, vals, back_left=None, back_right=None,
                 left=None, right=None, leaf=None):
        self.keys: np.ndarray = keys
        self.vals: np.ndarray = vals
        self.back_left = back_left
        self.back_right = back_right
        self.left: _CombNode | None = left
        self.right: _CombNode | None = right
        self.leaf: "_SparseFrontier | None" = leaf


class _SparseFrontier:
    """A domain's value-vs-spend frontier with backtracking state.

    ``keys``/``vals`` are the capped frontier (ascending quantized spends,
    best value at each).  Leaves keep their plan/curves/stages for
    unwinding; internal domains keep their children plus the aggregation
    tree (``comb``) that combined them.  ``token`` is the content token
    the parent's combine cache keys on.
    """

    __slots__ = (
        "dom", "keys", "vals", "stages", "plan", "curves", "curve_keys",
        "token", "comb", "children",
    )

    def __init__(self, dom, keys, vals, *, stages=None, plan=None,
                 curves=None, curve_keys=None, token=None, comb=None,
                 children=None):
        self.dom: DomainGroups = dom
        self.keys: np.ndarray = keys
        self.vals: np.ndarray = vals
        self.stages: list | None = stages
        self.plan: _LeafPlan | None = plan
        self.curves = curves
        self.curve_keys = curve_keys
        self.token: int | None = token
        self.comb: _CombNode | None = comb
        self.children: list["_SparseFrontier"] | None = children


def _combine_frontiers(
    subs: Sequence[_SparseFrontier], eff: float, state: HierState
) -> tuple[_CombNode, int]:
    """Fold child frontiers through the balanced aggregation tree under
    cap ``eff``.  Returns the root node and its content token."""
    nodes = [
        _CombNode(keys=f.keys, vals=f.vals, leaf=f) for f in subs
    ]
    tokens = [f.token for f in subs]
    effk = _qkey(eff)
    while len(nodes) > 1:
        nxt: list[_CombNode] = []
        ntok: list[int] = []
        for i in range(0, len(nodes) - 1, 2):
            key = (tokens[i], tokens[i + 1], effk)
            hit = state.comb_cache.get(key)
            if hit is None:
                hit = _maxplus_pair(
                    nodes[i].keys, nodes[i].vals,
                    nodes[i + 1].keys, nodes[i + 1].vals, eff,
                )
                state.comb_cache[key] = hit
            nxt.append(
                _CombNode(
                    keys=hit[0], vals=hit[1], back_left=hit[2],
                    back_right=hit[3], left=nodes[i], right=nodes[i + 1],
                )
            )
            ntok.append(state.token(("comb",) + key))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
            ntok.append(tokens[-1])
        nodes, tokens = nxt, ntok
    return nodes[0], tokens[0]


def _comb_spends(
    node: _CombNode, u: float, out: list[tuple[_SparseFrontier, float]]
) -> None:
    """Split a chosen spend ``u`` down the aggregation tree into per-child
    (frontier, spend) pairs in original child order."""
    if node.leaf is not None:
        out.append((node.leaf, u))
        return
    i = int(np.searchsorted(node.keys, u))
    _comb_spends(node.left, float(node.back_left[i]), out)
    _comb_spends(node.right, float(node.back_right[i]), out)


def _domain_eff(dom: DomainGroups, budget: float) -> float:
    """Effective spend cap of a domain under its parent's budget — the one
    clamping rule shared by the frontier builders and the batched-leaf
    pre-walks (divergence here would silently misalign their grids)."""
    eff = min(float(dom.cap), float(budget))
    return eff if eff > 0.0 else 0.0


def _prime_leaf_frontiers(
    root: DomainGroups, budget: float, state: HierState
) -> None:
    """Batched single-dispatch solve of every *dirty* leaf DP.

    Walks the domain tree computing each leaf's effective cap, collects
    the leaves whose frontier isn't cached, and solves them all through
    :func:`_superstage_dp_batch` — priming the frontier cache so the
    subsequent recursive build is all hits.  A steady-state round with k
    dirty leaves pays one batched dispatch instead of k per-leaf stage
    loops.  No-op (falling back to the per-leaf path) on non-lattice
    instances.
    """
    jobs: list[tuple[_LeafPlan, float, tuple]] = []
    seen: set = set()

    def walk(dom: DomainGroups, b: float) -> None:
        eff = _domain_eff(dom, b)
        if dom.children:
            for c in dom.children:
                walk(c, eff)
            return
        if not dom.groups:
            return
        plan = _leaf_plan(dom.groups, state.plan_cache)
        key = (plan.layout, _qkey(eff))
        if key in seen or state.frontier_cache.get(key) is not None:
            return
        seen.add(key)
        jobs.append((plan, eff, key))

    walk(root, float(budget))
    if len(jobs) < 2:
        return
    prepared = []
    for plan, eff, key in jobs:
        curves_, curve_keys = _class_curves(
            plan.classes, eff, state.curve_cache, state.chain_cache
        )
        prepared.append((plan, eff, key, curves_, curve_keys))
    batch = _superstage_dp_batch(
        [
            ([(c.keys, c.vals) for c in curves_], eff)
            for _, eff, _, curves_, _ in prepared
        ]
    )
    if batch is None:
        return
    for (plan, eff, key, curves_, curve_keys), (dp_keys, dp_vals, stages) in zip(
        prepared, batch
    ):
        state.frontier_cache[key] = (curves_, curve_keys, dp_keys, dp_vals, stages)


def _sparse_frontier(
    dom: DomainGroups, budget: float, state: HierState
) -> _SparseFrontier:
    """Capped frontier of one domain: its best-value-per-spend staircase,
    restricted to spends <= min(domain cap, parent budget).

    A leaf's frontier is the class super-stage DP of its groups — the same
    arrays ``solve_sparse_grouped`` ends on, so a single root domain with
    cap >= budget reproduces the flat grouped solve bit-for-bit.  An
    internal domain folds its children's frontiers through the balanced
    aggregation tree under its own cap (the "upper-level DP").  Leaf DPs
    memoize by (per-class digest+multiplicity layout, quantized budget);
    tree combines by the child content tokens — both in ``state``.
    """
    eff = _domain_eff(dom, budget)
    if dom.children:
        subs = [_sparse_frontier(c, eff, state) for c in dom.children]
        comb, token = _combine_frontiers(subs, eff, state)
        return _SparseFrontier(
            dom, comb.keys, comb.vals, token=token, comb=comb, children=subs
        )
    plan = _leaf_plan(dom.groups, state.plan_cache)
    key = (plan.layout, _qkey(eff))
    hit = state.frontier_cache.get(key)
    if hit is None:
        curves_, curve_keys = _class_curves(
            plan.classes, eff, state.curve_cache, state.chain_cache
        )
        dp_keys, dp_vals, stages = _superstage_dp(
            [(c.keys, c.vals) for c in curves_], eff
        )
        hit = (curves_, curve_keys, dp_keys, dp_vals, stages)
        state.frontier_cache[key] = hit  # type: ignore[index]
    curves_, curve_keys, dp_keys, dp_vals, stages = hit
    return _SparseFrontier(
        dom, dp_keys, dp_vals, stages=stages, plan=plan, curves=curves_,
        curve_keys=curve_keys, token=state.token(("leaf", key)),
    )


def _backtrack_frontier(
    f: _SparseFrontier,
    u: float,
    state: HierState,
    picks: dict[str, tuple[float, float, tuple[float, float]]],
    domain_spent: dict[str, float],
    leaf_totals: list[tuple[float, float]],
) -> None:
    """Walk a chosen spend ``u`` down the frontier tree to receiver picks.

    Leaf solutions (picks + canonically-accumulated totals) memoize by
    (leaf content token, membership plan key, per-class spends): an
    unchanged leaf whose budget share didn't move contributes its cached
    dict without re-unwinding a single class.
    """
    domain_spent[f.dom.name] = u
    if f.children is not None:
        pairs: list[tuple[_SparseFrontier, float]] = []
        _comb_spends(f.comb, u, pairs)
        for sub, s in pairs:
            _backtrack_frontier(sub, s, state, picks, domain_spent, leaf_totals)
        return
    spends = _backtrack_superstages(f.stages, u)
    skey = None
    if f.plan.key is not None:
        skey = (f.token, f.plan.key, tuple(spends))
        hit = state.leaf_sol_cache.get(skey)
        if hit is not None:
            picks.update(hit[0])
            leaf_totals.append((hit[1], hit[2]))
            return
    lp, lt, ls = _assemble_plan(
        f.plan, f.curve_keys, f.curves, spends, state.pick_cache
    )
    if skey is not None:
        state.leaf_sol_cache[skey] = (lp, lt, ls)
    picks.update(lp)
    leaf_totals.append((lt, ls))


def solve_hierarchical(
    root: DomainGroups,
    budget: float,
    *,
    solver: str = "sparse",
    unit: float = 1.0,
    curve_cache: MutableMapping | None = None,
    frontier_cache: MutableMapping | None = None,
    state: HierState | None = None,
    device: str | torch.device | None = None,
) -> MCKPSolution:
    """Topology-aware MCKP over an arbitrary-depth power-domain tree.

    Per-domain group-collapsed aggregate tables become capped value-vs-spend
    frontiers; the upper-level DP folds sibling frontiers through a
    balanced aggregation tree *recursively at every internal domain* to
    split each parent's budget subject to every domain's local cap (site
    → row → PDU → ... → leaf), then backtracks down to the per-receiver
    picks.  Every domain's spend is <= its cap by construction, and with a
    single root domain whose cap >= the cluster budget the result is
    **bit-for-bit** ``solve_sparse_grouped`` (``solver='sparse'``) /
    ``solve_dense_jax_grouped`` (``solver='jax'`` / ``'pallas'``, on
    ``device``: None = the CUDA card) — as the reference certifies for
    itself in tests/test_hier_alloc.py.

    Passing a persistent :class:`HierState` makes warm re-solves
    incremental (O(what changed) — see the class docstring) while staying
    bit-for-bit equal to a from-scratch call; ``curve_cache`` /
    ``frontier_cache`` remain accepted as standalone warm mappings.

    Returns a solution whose ``domain_spent`` maps each domain name to the
    watts spent inside it.
    """
    if solver == "sparse":
        st = state if state is not None else HierState(curve_cache, frontier_cache)
        _prime_leaf_frontiers(root, float(budget), st)
        f = _sparse_frontier(root, float(budget), st)
        u = float(f.keys[int(np.argmax(f.vals))])
        picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
        domain_spent: dict[str, float] = {}
        leaf_totals: list[tuple[float, float]] = []
        _backtrack_frontier(f, u, st, picks, domain_spent, leaf_totals)
        total = 0.0
        spent = 0.0
        for lt, ls in leaf_totals:
            total += lt
            spent += ls
        return MCKPSolution(
            total_value=total, spent=spent, picks=picks,
            domain_spent=domain_spent,
        )
    if solver in ("jax", "pallas"):
        return _solve_hier_dense(
            root, float(budget), unit=unit, backend=solver,
            device=resolve_device(device),
        )
    raise ValueError(f"unknown hierarchical solver {solver!r}")


# ---------------------------------------------------------------------------
# Receding-horizon (MPC) spend planning over cached frontiers (DESIGN.md §15)
# ---------------------------------------------------------------------------


def grouped_frontier(
    groups: Sequence[GroupedOptions],
    budget: float,
    *,
    curve_cache: MutableMapping | None = None,
    plan_cache: MutableMapping | None = None,
    chain_cache: MutableMapping | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The flat cluster's value-vs-spend frontier under ``budget``: the
    final ``(dp_keys, dp_vals)`` arrays of the grouped super-stage DP —
    exactly the states ``solve_sparse_grouped`` ends on, built from the
    same warm class-curve caches (so a planning call right before the
    round's solve costs one super-stage scan, not a re-aggregation)."""
    plan = _leaf_plan(groups, plan_cache)
    curves_, _ = _class_curves(plan.classes, budget, curve_cache, chain_cache)
    dp_keys, dp_vals, _ = _superstage_dp(
        [(c.keys, c.vals) for c in curves_], budget
    )
    return dp_keys, dp_vals


def hierarchical_frontier(
    root: DomainGroups, budget: float, state: HierState | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The root domain's capped value-vs-spend frontier under ``budget``
    (the frontier aggregation tree, warm through ``state``) — the
    hierarchical analogue of :func:`grouped_frontier`."""
    st = state if state is not None else HierState()
    _prime_leaf_frontiers(root, float(budget), st)
    f = _sparse_frontier(root, float(budget), st)
    return f.keys, f.vals


def frontier_records(
    keys: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Monotone record points of a frontier: the (spend, value) states
    where the running-max value strictly increases.

    Every record point is an *achievable* DP state (never an
    interpolation), and the smallest-spend argmax under any cap ``c`` is
    the last record point with spend <= ``c`` — the same state
    ``np.argmax`` (first max) picks in the myopic solvers, so planning on
    records commits only spends the real solve would also choose.
    """
    if len(keys) == 0:
        return keys, vals
    run = np.maximum.accumulate(vals)
    rec = np.ones(len(vals), dtype=bool)
    rec[1:] = vals[1:] > run[:-1]
    return keys[rec], vals[rec]


def plan_horizon(
    keys: np.ndarray,
    vals: np.ndarray,
    caps: Sequence[float],
    weights: Sequence[float] | None = None,
    *,
    eco_factor: float = 1.0,
    levels: int = 64,
    grid: int = 2048,
) -> list[float] | None:
    """Receding-horizon spend plan over one value-vs-spend frontier.

    Given the cluster frontier ``(keys, vals)`` (spends ascending, best
    value per spend) and an H-round cap forecast, choose per-round spends
    ``s_i`` maximizing ``sum_i value(s_i)`` subject to

     * ``s_i <= caps[i]`` — the instantaneous budget is *never* exceeded
       (the committed round-0 spend is a cap on that round's solve);
     * ``sum_i weights[i] * s_i <= eco_factor * sum_i weights[i] * umax_i``
       — the horizon's weighted spend (CO2 grams, dollars) may use at
       most an ``eco_factor`` fraction of what the myopic cap-riding
       controller would emit (``umax_i`` = the myopic best spend under
       ``caps[i]``).

    The temporal coupling is entirely in the weighted allowance: with
    ``eco_factor >= 1`` the per-round maxima are jointly feasible, the DP
    returns them, and the plan never restricts anything — so the function
    returns **None** ("don't touch the budget") and the caller takes the
    *literally unchanged* myopic code path, which is what certifies H=1
    and eco-off parity bit-for-bit.  With ``eco_factor < 1`` the DP banks
    spend away from dirty/expensive rounds (high weight) and rounds of
    diminishing marginal value, and toward clean rounds and upcoming
    deratings.

    Implementation: per-round candidates are the frontier's record points
    under that round's cap, subsampled to <= ``levels`` spends (the cap
    state and zero state always kept); the DP runs on an integer
    allowance lattice of ``grid`` cells with *ceil* cost rounding — so a
    returned plan's true weighted spend is <= the allowance, never over
    (conservative by construction).  Cost is O(H * levels * grid) numpy
    ops, independent of cluster size — the frontier did the heavy
    lifting.  Returns the planned spends (round order) or None when the
    plan would not restrict round 0.
    """
    H = len(caps)
    if H <= 1 or eco_factor >= 1.0 or len(keys) == 0:
        return None
    rk, rv = frontier_records(np.asarray(keys), np.asarray(vals))
    if len(rk) == 0 or rk[-1] <= 0.0:
        return None
    w = (
        np.ones(H, dtype=np.float64)
        if weights is None
        else np.clip(np.asarray(weights, dtype=np.float64), 0.0, None)
    )
    # per-round candidate spends/values + the myopic optimum under each cap
    cand_k: list[np.ndarray] = []
    cand_v: list[np.ndarray] = []
    umax = np.empty(H, dtype=np.float64)
    for i in range(H):
        hi = int(np.searchsorted(rk, float(caps[i]) + 1e-9))
        if hi == 0:
            # no positive-spend state fits: the only choice is state 0
            hi = 1
        umax[i] = rk[hi - 1]
        if hi > levels:
            idx = np.unique(
                np.round(np.linspace(0, hi - 1, levels)).astype(np.int64)
            )
        else:
            idx = np.arange(hi)
        cand_k.append(rk[idx])
        cand_v.append(rv[idx])
    allowance = float(eco_factor) * float(np.dot(w, umax))
    if allowance <= 0.0:
        plan = [float(k[0]) for k in cand_k]
        return None if plan[0] >= umax[0] - 1e-9 else plan
    q = allowance / float(grid)
    # integer ceil costs: sum(cost_cells) <= grid  =>  weighted spend <=
    # allowance exactly (each candidate's cells over-cover its true cost)
    costs = [
        np.ceil(w[i] * cand_k[i] / q - 1e-9).astype(np.int64)
        for i in range(H)
    ]
    neg = -np.inf
    dp = np.zeros(grid + 1, dtype=np.float64)
    wins: list[np.ndarray] = []
    t_axis = np.arange(grid + 1)
    for i in range(H):
        c, v = costs[i], cand_v[i]
        feas = c <= grid
        if not feas.any():
            return None
        c, v = c[feas], v[feas]
        # cand[j, t] = dp[t - c_j] + v_j where feasible
        shifted = np.full((len(c), grid + 1), neg)
        for j in range(len(c)):
            cj = int(c[j])
            shifted[j, cj:] = dp[: grid + 1 - cj] + v[j]
        win = np.argmax(shifted, axis=0)
        dp = shifted[win, t_axis]
        # record the candidate index in the unfiltered array for backtrack
        wins.append((np.flatnonzero(feas)[win], np.asarray(c)[win]))
    if not np.isfinite(dp[grid]):
        return None
    plan = [0.0] * H
    t = grid
    for i in range(H - 1, -1, -1):
        jfull, cwin = wins[i]
        j = int(jfull[t])
        plan[i] = float(cand_k[i][j])
        t -= int(cwin[t])
    return None if plan[0] >= umax[0] - 1e-9 else plan


# ---------------------------------------------------------------------------
# Fused device-resident sparse solve (DESIGN.md §14/§16/§17)
# ---------------------------------------------------------------------------

#: fused-path grid bound: fall back to host when the padded global spend
#: grid would exceed this many states (churn storms with tiny gcd pitches)
_FUSED_MAX_NB = 4096

#: per-stage option-count bound for the padded [S, L, K] device banks
_FUSED_MAX_OPTS = 1024

def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class FusedState:
    """Device-resident warm state for the fused steady-state round.

    Holds the padded ``[S, L, K]`` option banks — spend offsets on the
    shared integer micro-watt lattice (int32 ``kb``) and float64 values
    (``vb``) — as resident torch tensors on the round's device, the
    host-side per-row content signatures that drive delta patching, and
    the reversed per-stage key arrays the host assembly maps device
    backpointers through.  Banks use the reference's capacity-slack
    layouts (DESIGN.md §17): padded dims are quantized tiers (pow2
    options/grids, identity-row stage padding) that only ever grow, so
    churn inside the slack is pure row content:

     * same layout + same row signatures  -> zero upload;
     * same layout, k rows changed        -> the k rebuilt rows are
       written in place into the resident banks (``index_put_``);
     * layout changed (leaf set, pad tier growth) -> device-side
       compaction: a gather repacks every clean row into the new geometry
       and only dirty rows upload.

    Only the cold start (no resident banks, or banks on another device)
    builds banks on the host and uploads them whole (``stats['rebuilds']``).
    ``last_key``/``last_solution`` short-circuit the host assembly when the
    device decision vector is unchanged round over round.
    """

    def __init__(self):
        self.shape: tuple | None = None  # capacity-slack layout signature
        self.names: tuple | None = None  # per-leaf names (compaction map)
        self.row_sigs: list | None = None  # [L][S] per-row content sigs
        self.kb_dev: torch.Tensor | None = None  # [S, L, K] int32 bank
        self.vb_dev: torch.Tensor | None = None  # [S, L, K] float64 bank
        self.keys_desc: list | None = None  # [L][S] host reversed key arrays
        self.g: int = 0  # global micro-watt lattice pitch
        self.device: torch.device | None = None  # where the banks live
        self.last_key: tuple | None = None
        self.last_solution: MCKPSolution | None = None
        #: (curve key tuple) -> (leaf gcd pitch, per-class micro ints)
        self._leaf_ints: dict = {}
        #: row sig -> (kb desc, vals desc, keys desc, sig)
        self._row_cache: dict = {}
        #: last round's wall-clock split: prep/patch/compact/dispatch/
        #: backtrack/assembly seconds
        self.last_segments: dict = {}
        self.stats: dict = {
            "rounds": 0,
            "fallbacks": 0,
            "rebuilds": 0,
            "compactions": 0,
            "row_uploads": 0,
            "short_circuits": 0,
            "slack_utilization": 0.0,
            "device_s": 0.0,
            "fallback_reason": "",
        }

    def clear(self) -> None:
        self.shape = None
        self.names = None
        self.row_sigs = None
        self.kb_dev = None
        self.vb_dev = None
        self.keys_desc = None
        self.g = 0
        self.device = None
        self.last_key = None
        self.last_solution = None
        self._leaf_ints.clear()
        self._row_cache.clear()
        self.last_segments = {}


def _fused_leaf_rows(
    spec: tuple, fstate: FusedState
) -> tuple[int, int, list, bool] | None:
    """Per-leaf lattice prep, mirroring ``_superstage_dp_batch``'s per-job
    block: micro-int class keys, the leaf gcd pitch, and the per-stage
    descending (offsets, values, keys) rows.  None routes to host."""
    name, eff, plan, curves_, curve_keys = spec
    lkey = tuple(curve_keys)
    ent = fstate._leaf_ints.get(lkey)
    if ent is None:
        ints = []
        g_l = 0
        for c in curves_:
            ia = _micro_int(c.keys)
            if ia is None or not len(ia):
                return None
            ints.append(ia)
            g_l = int(np.gcd(g_l, np.gcd.reduce(ia)))
        all_zero = g_l == 0  # every class key is 0.0: the leaf can only spend 0
        if g_l <= 0:
            g_l = 1
        if len(fstate._leaf_ints) > 1024:
            fstate._leaf_ints.clear()
        ent = (g_l, ints, all_zero)
        fstate._leaf_ints[lkey] = ent
    g_l, ints, all_zero = ent
    if all_zero:
        tmax_host = 0  # zero-spend leaf: one state, any lattice pitch fits
    else:
        bound = np.floor((eff + 1e-9) * 1e6 / g_l)
        if not np.isfinite(bound) or bound < 0:
            return None
        tmax_host = int(bound)
    rows = []
    for s, (ia, curve, ckey) in enumerate(zip(ints, curves_, curve_keys)):
        sig = (ckey, g_l, tmax_host)
        row = fstate._row_cache.get(sig)
        if row is None:
            keep = np.flatnonzero(ia // g_l <= tmax_host)
            if not len(keep):
                return None
            kb = (ia[keep] // g_l)[::-1].copy()  # leaf-lattice units
            row = (
                kb,
                curve.vals[keep][::-1].copy(),
                curve.keys[keep][::-1].copy(),
                sig,
            )
            if len(fstate._row_cache) > 4096:
                fstate._row_cache.clear()
            fstate._row_cache[sig] = row
        rows.append(row)
    return g_l, tmax_host, rows, all_zero


@functools.cache
def _tree_ops(
    tree_sig: tuple | int, first_out: int
) -> tuple[tuple, dict, dict, tuple]:
    """Lower a nested domain signature to its static combine-op list.

    ``tree_sig``: leaf = spec row index; internal domain =
    ``("d", dom_idx, (child_sigs...))`` with ``dom_idx`` post-order.
    Rows ``0..L-1`` are the DFS leaves; each pairwise combine allocates
    the next row id from ``first_out``.  Per domain the ops replay
    ``_combine_frontiers``' balanced order exactly (adjacent pairs, odd
    tail carried up; a single-child domain emits no op — its cap already
    flows through the child's cascaded eff).  Returns ``(ops, depth,
    leaves_under, dom_rows)``: ops as ``(left_row, right_row, out_row,
    dom_idx)`` in topological order, per-row combine depth and leaf
    count, and each internal domain's result row.
    """
    ops: list[tuple[int, int, int, int]] = []
    depth: dict[int, int] = {}
    leaves_under: dict[int, int] = {}
    nxt = [first_out]
    dom_rows: dict[int, int] = {}

    def build(sig):
        if isinstance(sig, int):
            depth.setdefault(sig, 0)
            leaves_under.setdefault(sig, 1)
            return sig
        _tag, dom_idx, children = sig
        rows = [build(c) for c in children]
        while len(rows) > 1:
            merged = []
            for i in range(0, len(rows) - 1, 2):
                left, right = rows[i], rows[i + 1]
                out = nxt[0]
                nxt[0] += 1
                depth[out] = 1 + max(depth[left], depth[right])
                leaves_under[out] = leaves_under[left] + leaves_under[right]
                ops.append((left, right, out, dom_idx))
                merged.append(out)
            if len(rows) % 2:
                merged.append(rows[-1])
            rows = merged
        dom_rows[dom_idx] = rows[0]
        return rows[0]

    build(tree_sig)
    # renumber output rows into wave (depth) order: the round's row buffer
    # holds each wave's outputs contiguously, so a row's id must equal its
    # position — creation order interleaves domains and would not (the
    # stable sort keeps creation order within a depth)
    order = sorted(range(len(ops)), key=lambda i: depth[ops[i][2]])
    remap = {ops[i][2]: first_out + pos for pos, i in enumerate(order)}
    ops_w = tuple(
        (
            remap.get(ops[i][0], ops[i][0]),
            remap.get(ops[i][1], ops[i][1]),
            remap[ops[i][2]],
            ops[i][3],
        )
        for i in order
    )
    return (
        ops_w,
        {remap.get(r, r): d for r, d in depth.items()},
        {remap.get(r, r): v for r, v in leaves_under.items()},
        tuple(remap.get(dom_rows[i], dom_rows[i]) for i in range(len(dom_rows))),
    )


def _tree_waves(
    ops: tuple, depth: dict, leaves_under: dict, nb: int, nbt: int
) -> tuple:
    """Group combine ops into depth waves, one stage-kernel launch each.

    Ops at the same combine depth are independent (inputs come from
    strictly shallower rows), so each wave is one row-batched (max,+)
    launch.  Per wave, the enumerated right-offset count is the static
    support bound of its right inputs: ``min(nbt, max_right_leaves *
    (nb - 1) + 1)`` — offsets beyond a subtree's reachable spend are
    provably ``-inf`` and dropping them is bitwise-neutral.
    """
    by_depth: dict[int, list] = {}
    for op in ops:
        by_depth.setdefault(depth[op[2]], []).append(op)
    return tuple(
        (
            min(nbt, max(leaves_under[op[1]] for op in wave) * (nb - 1) + 1),
            tuple(wave),
        )
        for _d, wave in sorted(by_depth.items())
    )


def _fused_leaf_scan(
    kb: torch.Tensor, vb: torch.Tensor, tmax_leaf: torch.Tensor, nb: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched leaf super-stage DPs on the banks' device.

    All padded stages over all L leaf rows in one call
    (``kops.maxplus_stages_batched``: one kernel launch for CUDA banks),
    each stage followed by the per-leaf feasibility mask — the device image
    of ``_superstage_dp_batch``'s ``out[li, tmax+1:] = -inf``.
    Returns (dp [L, NB], wins [S, L, NB] int32 backpointers)."""
    dp = torch.full((kb.shape[1], nb), -torch.inf, dtype=vb.dtype, device=vb.device)
    dp[:, 0] = 0.0
    return kops.maxplus_stages_batched(dp, kb, vb, tmax_leaf)


def _tree_combine(
    dp: torch.Tensor, waves: tuple, tcuts: np.ndarray, nbt: int, n_rows: int
) -> tuple[torch.Tensor, list]:
    """The frontier aggregation waves on the device: the image of
    ``_combine_frontiers`` applying ``_maxplus_pair(..., eff)`` at every
    pair of an arbitrary-depth domain tree.

    Each wave is one launch of the sparse-option stage kernel
    (``kops.maxplus_stages_batched`` with S = 1) over the wave's left rows,
    with the dense descending offset row ``k_level - 1 .. 0`` as options and
    the right rows' first ``k_level`` states, reversed, as values (the
    ascending-j scan over descending offsets is the host's smallest
    a-spend tie-break), masked at each owning domain's cap cut through the
    kernel's ``tmax``.  ``buf`` [n_rows, NBT] holds the leaf rows, padded
    with -inf from NB to NBT, then each wave's outputs in append order.
    Returns (buf, the waves' [n_ops, NBT] int32 arg tables)."""
    L, nb = dp.shape
    device = dp.device
    # every wave's (left row, right row, cap cut) in one host -> device copy
    rows = torch.tensor(
        [[op[0], op[1], int(tcuts[op[3]])] for _, wave in waves for op in wave],
        dtype=torch.int64,
    ).to(device)
    buf = torch.empty((n_rows, nbt), dtype=dp.dtype, device=device)
    buf[:L, :nb] = dp
    buf[:L, nb:] = -torch.inf
    args = []
    at = 0
    for k_level, wave in waves:
        n = len(wave)
        li, ri, tc = rows[at : at + n].T
        ckb = torch.arange(k_level - 1, -1, -1, dtype=torch.int32, device=device)
        ckb = ckb.expand(1, n, k_level).contiguous()
        cvb = torch.flip(buf[ri, :k_level], (1,))[None]
        out, arg = kops.maxplus_stages_batched(buf[li], ckb, cvb, tc.to(torch.int32))
        buf[wave[0][2] : wave[0][2] + n] = out
        args.append(arg[0])
        at += n
    return buf, args


def _fused_run(
    specs: list[tuple],
    kind: str,
    tree_sig: tuple | int | None,
    doms: tuple,
    *,
    pick_cache: MutableMapping | None,
    fstate: FusedState,
    device: torch.device,
    st: "HierState | None" = None,
) -> MCKPSolution | None:
    """One fused device round over prepared leaf specs.

    ``specs``: per-leaf (name, eff, plan, curves, curve_keys) in DFS
    order.  ``kind``: 'flat' (grouped solve, no domain accounting),
    'leaf_root' (hierarchical root that is itself a leaf) or 'tree'
    (arbitrary-depth domain tree: ``tree_sig`` is the nested signature
    over spec indices and ``doms`` the post-order (name, eff) list of
    internal domains, root last).

    The device work is one launch of the stage kernel for the leaf scan
    and, for the tree kind, one a combine wave; one device -> host copy
    brings the root state, the backpointer tables and the offsets bank
    back, and the host walks them (int32, bitwise the reference's device
    gathers).  Structure churn never routes to the host (DESIGN.md §17):
    content changes patch rows in place under the unchanged
    capacity-slack layout, and layout changes (leaf set, pad tiers,
    topology edits) repack the resident banks by device-side compaction.
    Returns None only for off-lattice keys, oversized grids, empty rounds
    or an infeasible root; ``fstate.stats['fallback_reason']`` records
    which.  A kernel build or launch error is never caught here.
    """
    stats = fstate.stats
    seg = fstate.last_segments = {
        "prep_s": 0.0, "patch_s": 0.0, "compact_s": 0.0,
        "dispatch_s": 0.0, "backtrack_s": 0.0, "assembly_s": 0.0,
    }
    t_seg = time.perf_counter()
    if fstate.device is not None and fstate.device != device:
        fstate.clear()  # banks resident elsewhere: cold rebuild here
    L = len(specs)
    if L == 0:
        stats["fallbacks"] += 1
        stats["fallback_reason"] = "empty"
        return None

    prepped = []
    for spec in specs:
        pr = _fused_leaf_rows(spec, fstate)
        if pr is None:
            stats["fallbacks"] += 1
            stats["fallback_reason"] = "off_lattice"
            return None
        prepped.append(pr)

    g = 0
    for (g_l, _, rows, all_zero) in prepped:
        if rows and not all_zero:
            # zero-spend leaves contribute nothing: their only state (0)
            # sits on every lattice, so they must not shrink the pitch
            g = int(np.gcd(g, g_l))
    if g <= 0:
        g = 1

    s_max = 1
    k_max = 1
    nb_needed = 1
    tmax_dev = np.zeros(L, dtype=np.int32)
    for li, (g_l, tmax_host, rows, all_zero) in enumerate(prepped):
        if rows:
            mult = 1 if all_zero else g_l // g
            td = tmax_host * mult
            if td + 1 > _FUSED_MAX_NB:
                stats["fallbacks"] += 1
                stats["fallback_reason"] = "grid_overflow"
                return None
            tmax_dev[li] = td
            nb_needed = max(nb_needed, td + 1)
            s_max = max(s_max, len(rows))
            for kb, _, _, _ in rows:
                k_max = max(k_max, len(kb))

    use_tree = kind == "tree"
    tcuts = np.zeros(len(doms), dtype=np.int32)
    nbt_needed = nb_needed
    ops: tuple = ()
    depths: dict = {}
    leaves_under: dict = {}
    dom_rows: tuple = ()
    if use_tree:
        # the exact _maxplus_pair prune per internal domain: keep combined
        # states whose reconstructed float64 key is <= eff + 1e-9
        cut_by_eff: dict[float, int] = {}
        for i, (_dn, eff_d) in enumerate(doms):
            c = cut_by_eff.get(eff_d)
            if c is None:
                ub = int((eff_d + 1e-9) * 1e6 // g) + 1
                if ub + 1 > 4 * _FUSED_MAX_NB:
                    stats["fallbacks"] += 1
                    stats["fallback_reason"] = "grid_overflow"
                    return None
                ks = (np.arange(ub + 2, dtype=np.int64) * g).astype(np.float64) * 1e-6
                c = int(np.flatnonzero(ks <= eff_d + 1e-9).max())
                cut_by_eff[eff_d] = c
            tcuts[i] = c
        # one device: the leaf rows are not padded to a shard multiple
        ops, depths, leaves_under, dom_rows = _tree_ops(tree_sig, L)
        # the tree grid only needs the reachable spend-sum support: every
        # state beyond min(cap cut, sum of input supports) is -inf
        support = {li: int(tmax_dev[li]) for li in range(L)}
        for l_row, r_row, o_row, d in ops:
            support[o_row] = min(support[l_row] + support[r_row], int(tcuts[d]))
        nbt_needed = max(nb_needed, max(support.values()) + 1)

    if k_max > _FUSED_MAX_OPTS:
        stats["fallbacks"] += 1
        stats["fallback_reason"] = "grid_overflow"
        return None
    nb_pad = _pow2_at_least(nb_needed, 16)
    nbt_pad = _pow2_at_least(nbt_needed, 16) if use_tree else nb_pad
    if max(nb_pad, nbt_pad) > _FUSED_MAX_NB:
        stats["fallbacks"] += 1
        stats["fallback_reason"] = "grid_overflow"
        return None
    s_pad = max(1, -(-s_max // 8) * 8)
    k_pad = _pow2_at_least(max(k_max, 1), 4)

    names = tuple(name for name, *_ in specs)
    dom_names = tuple(dn for dn, _ in doms)
    # sticky pads: padding up is always exact (identity stages, -inf
    # option tails, masked grid tops), so never shrink the resident tiers
    # while the solver kind matches — churn across a pow2 boundary must
    # not flap between compactions
    if fstate.shape is not None and fstate.shape[0] == kind:
        _pk, _pL, ps, pkk, pnb, pnbt = fstate.shape[:6]
        s_pad = max(s_pad, ps)
        k_pad = max(k_pad, pkk)
        nb_pad = max(nb_pad, pnb)
        nbt_pad = max(nbt_pad, pnbt) if use_tree else nb_pad
    nbt_pad = max(nbt_pad, nb_pad)
    # capacity-slack layout signature (DESIGN.md §17): kind, leaf count,
    # padded tiers and the static tree schedule.  The pitch g, leaf names
    # and option rows are content, moved by the delta-patch or compaction
    # path; row signatures fold in the leaf->global lattice multiplier, so
    # a pitch change re-uploads exactly the rows whose device image it
    # moved.
    layout = (kind, L, s_pad, k_pad, nb_pad, nbt_pad, tree_sig)
    stats["slack_utilization"] = max(
        s_max / s_pad,
        k_max / k_pad,
        nb_needed / nb_pad,
        (nbt_needed / nbt_pad) if use_tree else 0.0,
    )

    bank_shape = (s_pad, L, k_pad)
    rebuild = fstate.shape is None
    compact = not rebuild and (
        fstate.shape != layout or tuple(fstate.kb_dev.shape) != bank_shape
    )
    if compact and (
        fstate.shape[0] != kind
        or len(set(names)) != len(names)
        or len(set(fstate.names or ())) != len(fstate.names or ())
    ):
        # unmappable resident state (different solver kind, ambiguous leaf
        # identities): cold host rebuild — still a fused round
        rebuild, compact = True, False

    def upload_rows(entries):
        # entries: (s, li, kb_glob | None, vb | None); None = identity row.
        # Written in place into the resident banks (index_put_).
        m = len(entries)
        s_np = np.empty(m, dtype=np.int64)
        l_np = np.empty(m, dtype=np.int64)
        kb_rows = np.zeros((m, k_pad), dtype=np.int32)
        vb_rows = np.full((m, k_pad), -np.inf)
        for i, (s, li, kbg, vb) in enumerate(entries):
            s_np[i] = s
            l_np[i] = li
            if kbg is None:
                vb_rows[i, 0] = 0.0
            else:
                kb_rows[i, : len(kbg)] = kbg
                vb_rows[i, : len(vb)] = vb
        si = torch.from_numpy(s_np).to(device)
        lj = torch.from_numpy(l_np).to(device)
        fstate.kb_dev[si, lj] = torch.from_numpy(kb_rows).to(device)
        fstate.vb_dev[si, lj] = torch.from_numpy(vb_rows).to(device)
        stats["row_uploads"] += m
        fstate.last_key = None

    seg["prep_s"] = time.perf_counter() - t_seg
    t_seg = time.perf_counter()
    if rebuild:
        # cold start (or unmappable state): host-built banks, one full
        # upload — the only non-O(churn) sync point
        kb_np = np.zeros((s_pad, L, k_pad), dtype=np.int32)
        vb_np = np.full((s_pad, L, k_pad), -np.inf)
        vb_np[:, :, 0] = 0.0  # identity padding stages/rows: spend 0, +0.0
        row_sigs: list[list] = [[None] * s_pad for _ in range(L)]
        keys_desc: list[list] = [[None] * s_pad for _ in range(L)]
        for li, (g_l, tmax_host, rows, all_zero) in enumerate(prepped):
            mult = 1 if all_zero else g_l // g
            for s, (kb, vb, keys, sig) in enumerate(rows):
                n = len(kb)
                kb_np[s, li, :n] = kb * mult
                vb_np[s, li, :n] = vb
                vb_np[s, li, n:] = -np.inf
                row_sigs[li][s] = (sig, mult)
                keys_desc[li][s] = keys
        fstate.kb_dev = torch.from_numpy(kb_np).to(device)
        fstate.vb_dev = torch.from_numpy(vb_np).to(device)
        fstate.device = device
        fstate.row_sigs = row_sigs
        fstate.keys_desc = keys_desc
        fstate.shape = layout
        fstate.names = names
        fstate.g = g
        fstate.last_key = None
        fstate.last_solution = None
        stats["rebuilds"] += 1
        seg["patch_s"] += time.perf_counter() - t_seg
    elif compact:
        # device-side compaction (DESIGN.md §17): repack every row whose
        # content signature survived with one gather out of the old banks
        # (zero upload), then write only the dirty rows
        old_pos = {nm: i for i, nm in enumerate(fstate.names or ())}
        o_s_pad = int(fstate.kb_dev.shape[0])
        src_s = np.full((s_pad, L), -1, dtype=np.int64)
        src_l = np.full((s_pad, L), -1, dtype=np.int64)
        row_sigs = [[None] * s_pad for _ in range(L)]
        keys_desc = [[None] * s_pad for _ in range(L)]
        dirty: list[tuple] = []
        for li, (g_l, tmax_host, rows, all_zero) in enumerate(prepped):
            mult = 1 if all_zero else g_l // g
            oli = old_pos.get(names[li])
            for s in range(s_pad):
                if s < len(rows):
                    kb, vb, keys, sig = rows[s]
                    esig = (sig, mult)
                else:
                    kb = vb = keys = None
                    esig = None
                row_sigs[li][s] = esig
                keys_desc[li][s] = keys
                if esig is None:
                    continue  # identity rows come from the init
                if (
                    oli is not None
                    and s < o_s_pad
                    and fstate.row_sigs[oli][s] == esig
                ):
                    src_s[s, li] = s
                    src_l[s, li] = oli
                else:
                    dirty.append((s, li, kb * mult, vb))
        fstate.kb_dev, fstate.vb_dev = kops.bank_compact(
            fstate.kb_dev, fstate.vb_dev,
            torch.from_numpy(src_s).to(device),
            torch.from_numpy(src_l).to(device),
            k_pad=k_pad,
        )
        fstate.row_sigs = row_sigs
        fstate.keys_desc = keys_desc
        fstate.shape = layout
        fstate.names = names
        fstate.g = g
        fstate.last_key = None
        fstate.last_solution = None
        stats["compactions"] += 1
        seg["compact_s"] += time.perf_counter() - t_seg
        t_seg = time.perf_counter()
        if dirty:
            upload_rows(dirty)
        seg["patch_s"] += time.perf_counter() - t_seg
    else:
        # delta patch: write only the rows whose content signature moved
        entries: list[tuple] = []
        for li, (g_l, tmax_host, rows, all_zero) in enumerate(prepped):
            mult = 1 if all_zero else g_l // g
            for s in range(s_pad):
                if s < len(rows):
                    kb, vb, keys, sig = rows[s]
                    esig = (sig, mult)
                else:
                    kb = vb = keys = None
                    esig = None
                if fstate.row_sigs[li][s] == esig:
                    continue
                entries.append((s, li, None if kb is None else kb * mult, vb))
                fstate.row_sigs[li][s] = esig
                fstate.keys_desc[li][s] = keys
        if entries:
            upload_rows(entries)
        fstate.names = names
        fstate.g = g
        seg["patch_s"] += time.perf_counter() - t_seg

    t0 = time.perf_counter()
    kb_dev, vb_dev = fstate.kb_dev, fstate.vb_dev
    dp, wins = _fused_leaf_scan(
        kb_dev, vb_dev, torch.from_numpy(tmax_dev).to(device), nb_pad
    )
    waves: tuple = ()
    wave_args: list = []
    root_row = 0
    if use_tree:
        waves = _tree_waves(ops, depths, leaves_under, nb_pad, nbt_pad)
        root_row = dom_rows[-1]
        buf, wave_args = _tree_combine(dp, waves, tcuts, nbt_pad, L + len(ops))
        root_vec = buf[root_row]
    else:
        root_vec = dp[0]
    # first maximum taken explicitly
    root_val = root_vec.max()
    t_root_dev = torch.nonzero(root_vec == root_val)[0, 0]
    # one device -> host copy: the root, the leaf and wave backpointers and
    # the offsets bank the backtrack walks (int32)
    head = torch.stack([t_root_dev.to(torch.int32)])
    parts = [head, wins.reshape(-1), kb_dev.reshape(-1)]
    parts += [a.reshape(-1) for a in wave_args]
    host = torch.cat(parts).cpu().numpy()
    root_val = float(root_val)
    stats["device_s"] += time.perf_counter() - t0
    seg["dispatch_s"] += time.perf_counter() - t0
    stats["rounds"] += 1

    t_seg = time.perf_counter()
    if not np.isfinite(root_val):
        # no feasible root state: keep the host path authoritative
        stats["fallbacks"] += 1
        stats["fallback_reason"] = "no_feasible_root"
        return None
    stats["fallback_reason"] = ""
    t_root = int(host[0])
    at = 1
    wins_h = host[at : at + wins.numel()].reshape(wins.shape)
    at += wins.numel()
    kb_h = host[at : at + kb_dev.numel()].reshape(kb_dev.shape)
    at += kb_dev.numel()
    # tree backtrack: split t down the static schedule in reverse wave
    # order (an op's output t is known before its inputs are needed)
    t_of = {root_row: t_root}
    wave_h = []
    for (k_level, wave) in waves:
        n = len(wave) * nbt_pad
        wave_h.append(host[at : at + n].reshape(len(wave), nbt_pad))
        at += n
    for (k_level, wave), win in zip(reversed(waves), reversed(wave_h)):
        for i in range(len(wave) - 1, -1, -1):
            l_row, r_row, o_row, _d = wave[i]
            t_out = t_of[o_row]
            t_r = k_level - 1 - int(win[i, t_out])
            t_of[r_row] = t_r
            t_of[l_row] = t_out - t_r
    t_leaf = np.array([t_of[i] for i in range(L)], dtype=np.int32)
    t_dom = [t_of[r] for r in dom_rows]
    # leaf backtrack through the backpointer tables, stage by stage —
    # _IntStages.backtrack for every leaf at once (int32, bitwise)
    js = np.empty((L, wins.shape[0]), dtype=np.int32)
    rows_i = np.arange(L)
    t = t_leaf.copy()
    for s in range(wins.shape[0] - 1, -1, -1):
        j = wins_h[s, rows_i, t]
        js[:, s] = j
        t = (t - kb_h[s, rows_i, j]).astype(np.int32)

    leaf_meta = []
    for name, eff, plan_, curves_, curve_keys in specs:
        tok = (
            st.token(("leaf", (plan_.layout, _qkey(eff))))
            if st is not None
            else None
        )
        leaf_meta.append((tok, plan_.key))

    # layout does not pin pitch / leaf names / class layouts (they are
    # patchable content), so the short-circuit key carries them explicitly
    dec_key = (
        layout,
        g,
        names,
        dom_names,
        tuple(tuple(rs) for rs in fstate.row_sigs),
        tuple(leaf_meta),
        t_root,
        t_leaf.tobytes(),
        js.tobytes(),
    )
    seg["backtrack_s"] += time.perf_counter() - t_seg
    t_seg = time.perf_counter()
    if dec_key == fstate.last_key and fstate.last_solution is not None:
        # unchanged device decision vector: the previous solution is the
        # bit-identical answer — skip the host assembly entirely
        stats["short_circuits"] += 1
        return fstate.last_solution

    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    domain_spent: dict[str, float] | None = (
        {} if kind in ("tree", "leaf_root") else None
    )
    if use_tree:
        # per-internal-domain spends off the backtrack: the float64(t * g)
        # * 1e-6 reconstruction is the host frontier-key round trip, so the
        # values are bitwise _backtrack_frontier's
        for i, (dname, _de) in enumerate(doms):
            domain_spent[dname] = float(np.float64(int(t_dom[i]) * g) * 1e-6)
    leaf_totals: list[tuple[float, float]] = []
    for li, ((name, eff, plan_, curves_, curve_keys), (tok, _pk)) in enumerate(
        zip(specs, leaf_meta)
    ):
        u = float(np.float64(int(t_leaf[li]) * g) * 1e-6)
        if domain_spent is not None:
            domain_spent[name] = u
        spends = [
            float(fstate.keys_desc[li][s][int(js[li, s])])
            for s in range(len(plan_.classes))
        ]
        skey = None
        if st is not None and plan_.key is not None:
            skey = (tok, plan_.key, tuple(spends))
            hit = st.leaf_sol_cache.get(skey)
            if hit is not None:
                picks.update(hit[0])
                leaf_totals.append((hit[1], hit[2]))
                continue
        lp, lt, ls = _assemble_plan(plan_, curve_keys, curves_, spends, pick_cache)
        if skey is not None:
            st.leaf_sol_cache[skey] = (lp, lt, ls)
        picks.update(lp)
        leaf_totals.append((lt, ls))

    total = 0.0
    spent = 0.0
    for lt, ls in leaf_totals:
        total += lt
        spent += ls
    sol = MCKPSolution(
        total_value=total, spent=spent, picks=picks, domain_spent=domain_spent
    )
    fstate.last_key = dec_key
    fstate.last_solution = sol
    seg["assembly_s"] += time.perf_counter() - t_seg
    return sol


def solve_grouped_fused(
    groups: Sequence[GroupedOptions],
    budget: float,
    *,
    fstate: FusedState,
    curve_cache: MutableMapping | None = None,
    pick_cache: MutableMapping | None = None,
    plan_cache: MutableMapping | None = None,
    chain_cache: MutableMapping | None = None,
    device: str | torch.device | None = None,
) -> MCKPSolution | None:
    """Fused device-resident form of :func:`solve_sparse_grouped` on
    ``device`` (None = the CUDA card).

    Returns the bit-for-bit identical solution, or None to fall back to
    the host path (off-lattice keys, oversized grids, empty rounds,
    infeasible roots).  Group/class churn is not a fallback: it patches or
    compacts the resident banks and solves fused in the same call.
    """
    device = resolve_device(device)
    plan = _leaf_plan(groups, plan_cache)
    curves_, curve_keys = _class_curves(
        plan.classes, budget, curve_cache, chain_cache
    )
    eff = float(budget)
    specs = [(None, eff, plan, curves_, curve_keys)]
    return _fused_run(
        specs, "flat", None, (), pick_cache=pick_cache, fstate=fstate,
        device=device,
    )


def solve_hierarchical_fused(
    root: DomainGroups,
    budget: float,
    *,
    state: HierState,
    fstate: FusedState,
    device: str | torch.device | None = None,
) -> MCKPSolution | None:
    """Fused device-resident form of the N-level sparse
    :func:`solve_hierarchical` on ``device`` (None = the CUDA card).

    Walks the arbitrary-depth domain tree on the host exactly like
    ``_sparse_frontier`` (same cascaded effective caps, plans and class
    curves — shared caches), lowering it to a static combine schedule plus
    a per-domain cap-cut vector, then runs the leaf scan and the combine
    waves on the device (DESIGN.md §16).  Returns None to fall back to the
    host path: off-lattice keys, oversized grids, empty rounds or an
    infeasible root — ``fstate.stats['fallback_reason']`` says which.
    Structure changes (new class layouts, membership churn, topology
    edits) are served fused in the same round by row patching or
    device-side compaction of the resident banks (DESIGN.md §17).
    """
    device = resolve_device(device)
    eff_root = _domain_eff(root, float(budget))
    if not root.children:
        plan = _leaf_plan(root.groups, state.plan_cache)
        curves_, curve_keys = _class_curves(
            plan.classes, eff_root, state.curve_cache, state.chain_cache
        )
        specs = [(root.name, eff_root, plan, curves_, curve_keys)]
        return _fused_run(
            specs, "leaf_root", None, (),
            pick_cache=state.pick_cache, fstate=fstate, device=device, st=state,
        )

    specs = []
    doms: list[tuple[str, float]] = []

    def walk(dom: DomainGroups, b: float):
        eff = _domain_eff(dom, b)
        if dom.children:
            child_sigs = tuple(walk(c, eff) for c in dom.children)
            doms.append((dom.name, eff))
            return ("d", len(doms) - 1, child_sigs)
        plan = _leaf_plan(dom.groups, state.plan_cache)
        curves_, curve_keys = _class_curves(
            plan.classes, eff, state.curve_cache, state.chain_cache
        )
        specs.append((dom.name, eff, plan, curves_, curve_keys))
        return len(specs) - 1

    tree_sig = walk(root, float(budget))
    return _fused_run(
        specs, "tree", tree_sig, tuple(doms),
        pick_cache=state.pick_cache, fstate=fstate, device=device, st=state,
    )


# ---------------------------------------------------------------------------
# Dense-grid DP (numpy)
# ---------------------------------------------------------------------------


def _stage_maxplus(
    dp: np.ndarray, costs_u: np.ndarray, values: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One (max,+) stage restricted to option costs.

    dp'[b] = max_j dp[b - cost_j] + value_j   (invalid b-cost_j masked)
    Returns (dp', argmax_j) with first-max tie-breaking.  The options are
    scanned in ascending j with a strict ``>`` from (-inf, 0) — the first
    maximizer, as the reference's argmax over its [k, b] candidate tile
    picks it, with the same float64 sums — so no tile is built: the full
    (max,+) convolution of the hierarchical dense path, whose options are
    the whole budget grid, costs O(nb) memory.  Values are finite or
    -inf (an unreachable spend): a NaN candidate, which the reference's
    argmax would take for the maximum, cannot arise.
    """
    nb = dp.shape[0]
    out = np.full(nb, -np.inf)
    arg = np.zeros(nb, dtype=np.int32)
    for j, (c, v) in enumerate(zip(costs_u.tolist(), values.tolist())):
        if c >= nb:
            continue  # every candidate off the grid: -inf, never a maximizer
        cand = dp[: nb - c] + v
        tail = out[c:]
        better = cand > tail
        np.copyto(tail, cand, where=better)
        np.copyto(arg[c:], j, where=better)
    return out, arg


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


# ---------------------------------------------------------------------------
# Hierarchical dense solve: leaf gather scans on a torch device, frontier
# combines in numpy (DESIGN.md §12)
# ---------------------------------------------------------------------------


class _DenseFrontier:
    """Dense analogue of :class:`_SparseFrontier`: ``f[k]`` is the domain's
    best value at spend ``k`` units (length min(cap, budget)//unit + 1 — the
    cap restriction is the truncation).  Leaves keep their grouped dense
    layout for backtracking; internal domains keep per-child conv argmaxes.
    """

    __slots__ = ("dom", "f", "args", "layout", "children")

    def __init__(self, dom, f, args, layout=None, children=None):
        self.dom: DomainGroups = dom
        self.f: np.ndarray = f
        self.args = args
        self.layout = layout
        self.children: list["_DenseFrontier"] | None = children


def _conv_full(dp: np.ndarray, f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full (max,+) convolution: out[b] = max_k dp[b-k] + f[k].

    ``f`` may be shorter than ``dp`` (a capped child frontier).  One
    :func:`_stage_maxplus` stage whose "options" are every grid spend."""
    return _stage_maxplus(dp, np.arange(len(f)), f)


#: padded-element ceiling for the single-launch batched leaf solve
#: (L x N x NB argmax tables); beyond it leaves solve one by one
_BATCH_LEAF_MAX_ELEMS = 150_000_000


def _scan_batched(f_banks: np.ndarray, gids: np.ndarray, backend: str, device):
    """The batched leaf gather scan on ``device``: the float64 banks go to
    float32 there (as the reference's jnp conversion with x64 off makes
    them), then ``"pallas"`` runs ``ops.maxplus_scan_batched`` (kernel 2.2,
    one launch a stage over every leaf row) and anything else the same scan
    on the plain version.  Returns numpy (dp [L, NB], args [L, N, NB])."""
    f = _curves_on(f_banks, device)
    g = torch.as_tensor(gids, dtype=torch.int64, device=device)
    if backend == "pallas":
        dp, args = kops.maxplus_scan_batched(f, g)
    else:
        rows = torch.arange(f.shape[0], device=device)
        dp = torch.zeros((f.shape[0], f.shape[2]), dtype=f.dtype, device=device)
        steps = []
        for i in range(g.shape[1]):
            dp, arg = kref.maxplus_conv_batched(dp, f[rows, g[:, i]])
            steps.append(arg)
        args = torch.stack(steps, dim=1)
    return dp.cpu().numpy(), args.cpu().numpy()


def _batch_dense_leaves(
    root: DomainGroups, budget: float, unit: float, backend: str, device
) -> dict[int, tuple]:
    """Single-launch-a-stage batched solve of every non-empty leaf's gather
    scan.

    Collects each leaf's (groups, eff) pair, densifies every leaf's class
    curves on the widest leaf grid, pads class banks with the identity
    curve and stage sequences with the identity class id, and runs one
    batched scan for all leaves (:func:`_scan_batched`).  Per-leaf slices
    are bitwise what the per-leaf scan returns: grid positions past a
    leaf's own budget never influence positions inside it, and identity
    stages are exact (+0.0) no-ops.  Returns {id(dom): (layout, dp_final,
    args)}; empty when batching is inapplicable (single leaf, or padded
    size beyond the ceiling).
    """
    leaves: list[tuple[DomainGroups, float]] = []

    def walk(dom: DomainGroups, b: float) -> None:
        eff = _domain_eff(dom, b)
        if dom.children:
            for c in dom.children:
                walk(c, eff)
        elif dom.groups:
            leaves.append((dom, eff))

    walk(root, float(budget))
    if len(leaves) < 2:
        return {}
    nbs = [int(np.floor(eff / unit + 1e-9)) + 1 for _, eff in leaves]
    nb_max = max(nbs)
    layouts = [
        _grouped_dense_layout(dom.groups, (nb_max - 1) * unit, unit)
        for dom, _ in leaves
    ]
    g_max = max(lay[3].shape[0] for lay in layouts)
    n_max = max(len(lay[1]) for lay in layouts)
    if len(leaves) * n_max * nb_max > _BATCH_LEAF_MAX_ELEMS:
        return {}
    identity = np.full(nb_max, -np.inf)
    identity[0] = 0.0
    f_banks = np.empty((len(leaves), g_max + 1, nb_max), dtype=np.float64)
    gids_pad = np.empty((len(leaves), n_max), dtype=np.int32)
    for li, lay in enumerate(layouts):
        _, stage_gids, _, f_groups, _ = lay
        g_l, n_l = f_groups.shape[0], len(stage_gids)
        f_banks[li, :g_l] = f_groups
        f_banks[li, g_l:] = identity
        gids_pad[li, :n_l] = stage_gids
        gids_pad[li, n_l:] = g_l  # identity stage: dp + 0.0
    dp_all, args_all = _scan_batched(f_banks, gids_pad, backend, device)
    out: dict[int, tuple] = {}
    for li, ((dom, _), lay, nb) in enumerate(zip(leaves, layouts, nbs)):
        n_l = len(lay[1])
        out[id(dom)] = (lay, dp_all[li, :nb], args_all[li, :n_l, :nb])
    return out


def _dense_frontier(
    dom: DomainGroups,
    budget: float,
    unit: float,
    backend: str,
    device,
    batched: dict[int, tuple] | None = None,
) -> _DenseFrontier:
    """Capped dense frontier of one domain on the ``unit``-watt grid.

    A leaf runs the repeated-stage gather scan of its groups (the same
    convolutions as ``solve_dense_jax_grouped``, so a single root with
    cap >= budget is bitwise identical to the flat solve) — or picks up
    its slice of the batched solve when one ran; an internal domain
    convolves its children's truncated frontiers in numpy (float64).
    """
    eff = _domain_eff(dom, budget)
    nb = int(np.floor(eff / unit + 1e-9)) + 1
    if dom.children:
        subs = [
            _dense_frontier(c, eff, unit, backend, device, batched)
            for c in dom.children
        ]
        dp = np.zeros(nb, dtype=np.float64)
        args: list[np.ndarray] = []
        for sub in subs:
            dp, arg = _conv_full(dp, sub.f)
            args.append(arg)
        return _DenseFrontier(dom, dp, args, children=subs)
    if not dom.groups:
        # no receivers under this leaf: zero spend or nothing
        f = np.full(nb, -np.inf)
        f[0] = 0.0
        return _DenseFrontier(dom, f, None, layout=None)
    hit = batched.get(id(dom)) if batched else None
    if hit is not None:
        layout, dp_final, args_arr = hit
        return _DenseFrontier(dom, dp_final, args_arr, layout=layout)
    layout = _grouped_dense_layout(dom.groups, eff, unit)
    _, stage_gids, _, f_groups, _ = layout
    dp_final, args = _jax_dp_gather(f_groups, stage_gids, backend, device)
    return _DenseFrontier(
        dom, dp_final.cpu().numpy(), args.cpu().numpy(), layout=layout
    )


def _backtrack_dense(
    fr: _DenseFrontier,
    b: int,
    picks: dict[str, tuple[float, float, tuple[float, float]]],
    domain_spent: dict[str, float],
) -> float:
    """Walk ``b`` granted units down the frontier tree into picks; returns
    the watts actually spent inside this domain."""
    spent = 0.0
    if fr.children is not None:
        for i in range(len(fr.children) - 1, -1, -1):
            k = int(fr.args[i][b])
            spent += _backtrack_dense(fr.children[i], k, picks, domain_spent)
            b -= k
    elif fr.layout is not None:
        spent = _gather_backtrack(fr.layout, fr.args, b, picks)
    domain_spent[fr.dom.name] = spent
    return spent


def _solve_hier_dense(
    root: DomainGroups,
    budget: float,
    *,
    unit: float = 1.0,
    backend: str = "jax",
    device: torch.device,
) -> MCKPSolution:
    """Dense-grid hierarchical solve (see :func:`solve_hierarchical`)."""
    batched = _batch_dense_leaves(root, budget, unit, backend, device)
    fr = _dense_frontier(root, budget, unit, backend, device, batched)
    b = int(np.argmax(fr.f))
    total = float(fr.f[b])
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    domain_spent: dict[str, float] = {}
    _backtrack_dense(fr, b, picks, domain_spent)
    spent = sum(c for c, _, _ in picks.values())
    return MCKPSolution(
        total_value=total, spent=spent, picks=picks, domain_spent=domain_spent
    )


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

# ---------------------------------------------------------------------------
# Exhaustive brute force (Oracle ground truth for small cases)
# ---------------------------------------------------------------------------


def brute_force(options: Sequence[OptionTable], budget: float) -> MCKPSolution:
    """Exhaustive DFS over the cross product of option sets.

    Exponential — used for the §6.3 Oracle on <= ~10 apps with pruned
    option sets, and to certify the DP solvers in tests.  A simple
    optimistic bound (sum of per-app max remaining values) prunes branches.
    """
    n = len(options)
    # optimistic suffix bound
    suffix_max = np.zeros(n + 1)
    for i in range(n - 1, -1, -1):
        suffix_max[i] = suffix_max[i + 1] + float(np.max(options[i].values))

    best = {"total": -1.0, "choice": [0] * n}
    choice = [0] * n

    def dfs(i: int, used: float, value: float) -> None:
        if value + suffix_max[i] <= best["total"]:
            return
        if i == n:
            if value > best["total"]:
                best["total"] = value
                best["choice"] = list(choice)
            return
        opt = options[i]
        for j in range(opt.k - 1, -1, -1):
            e = float(opt.costs[j])
            if used + e > budget + 1e-9:
                continue
            choice[i] = j
            dfs(i + 1, used + e, value + float(opt.values[j]))
        choice[i] = 0

    dfs(0, 0.0, 0.0)
    picks: dict[str, tuple[float, float, tuple[float, float]]] = {}
    for i, opt in enumerate(options):
        j = best["choice"][i]
        picks[opt.name] = (
            float(opt.costs[j]),
            float(opt.values[j]),
            (float(opt.caps[j, 0]), float(opt.caps[j, 1])),
        )
    spent = sum(c for c, _, _ in picks.values())
    return MCKPSolution(total_value=best["total"], spent=spent, picks=picks)
