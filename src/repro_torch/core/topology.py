"""Hierarchical power domains: the facility's cap topology (DESIGN.md §12).

Real power-constrained facilities cascade limits down a tree — site → row →
rack/PDU → node — and a flat allocator can reclaim power into a rack that
physically cannot draw it.  A :class:`PowerTopology` makes that tree
first-class:

 * every :class:`PowerDomain` carries a **cap trace** (scalar, per-round
   sequence, or callable — the same trace forms as scenario budgets) giving
   its max total draw in watts per round;
 * **leaves own node-id ranges** (half-open ``[lo, hi)`` intervals); internal
   domains own the union of their children;
 * node → domain interning is one vectorized ``searchsorted`` over the
   sorted leaf range bounds, so a 10k-node cluster maps its whole id column
   in one pass.

Domains are indexed in deterministic DFS preorder (the root is id 0); the
``parent`` array lets per-leaf sums aggregate to every ancestor in one
reverse sweep.  The allocation math lives in ``repro_torch.core.mckp``
(``solve_hierarchical``); the per-round draw accounting in
``repro_torch.cluster.sim``.

The port of ``repro.core.topology``, carried over as is (numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence, Union

import numpy as np

#: cap trace: scalar (constant), sequence (holds last value), callable, or a
#: BudgetProvider (anything exposing ``budget_at(r)``), so a rack can ride
#: a provider like the cluster budget
CapTrace = Union[float, Sequence, Callable[[int], float]]


def cap_trace_at(trace: CapTrace, r: int) -> float:
    """Resolve a cap trace at round ``r`` (same forms as scenario budgets).

    ``BudgetProvider``s are first-class cap traces: anything with a
    ``budget_at`` method resolves through it — the same duck-typing
    ``repro_torch.cluster.budget.as_provider`` coerces on, so one provider
    object can drive both the cluster budget and a domain cap.
    """
    budget_at = getattr(trace, "budget_at", None)
    if budget_at is not None and callable(budget_at):
        return float(budget_at(r))
    if isinstance(trace, (int, float)):
        return float(trace)
    if callable(trace):
        return float(trace(r))
    if len(trace) == 0:
        raise ValueError("empty cap trace")
    return float(trace[min(r, len(trace) - 1)])


@dataclasses.dataclass(frozen=True)
class PowerDomain:
    """One named domain in the facility tree.

    Exactly one of ``children`` / ``nodes`` is non-empty: an *internal*
    domain caps the union of its children, a *leaf* domain owns node-id
    ranges directly.  ``cap`` is the domain's max total draw (watts) — a
    trace resolved per round via :func:`cap_trace_at`.
    """

    name: str
    cap: CapTrace
    children: tuple["PowerDomain", ...] = ()
    #: half-open [lo, hi) node-id ranges (leaves only)
    nodes: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        if bool(self.children) == bool(self.nodes):
            raise ValueError(
                f"domain {self.name!r} must have children xor node ranges"
            )
        for lo, hi in self.nodes:
            if not 0 <= lo < hi:
                raise ValueError(
                    f"domain {self.name!r}: bad node range [{lo}, {hi})"
                )
        if isinstance(self.cap, (int, float)) and self.cap <= 0:
            raise ValueError(f"domain {self.name!r}: cap must be positive")

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def cap_at(self, r: int) -> float:
        return cap_trace_at(self.cap, r)


class PowerTopology:
    """Validated domain tree with vectorized node → leaf interning.

    ``domains`` lists every domain in DFS preorder; ``index`` maps name →
    preorder id, ``parent[i]`` is the id of ``domains[i]``'s parent (-1 for
    the root), and ``leaf_ids`` the ids of the leaves.  Construction
    validates name uniqueness and leaf-range disjointness; passing
    ``n_nodes`` additionally validates *coverage* — the leaf ranges must
    tile ``[0, n_nodes)`` exactly, with no gap at any depth.
    """

    def __init__(self, root: PowerDomain, n_nodes: int | None = None):
        self.root = root
        self.domains: list[PowerDomain] = []
        self.parent: np.ndarray
        self.index: dict[str, int] = {}
        parents: list[int] = []

        def visit(d: PowerDomain, parent_id: int) -> None:
            if d.name in self.index:
                raise ValueError(f"duplicate domain name {d.name!r}")
            my_id = len(self.domains)
            self.index[d.name] = my_id
            self.domains.append(d)
            parents.append(parent_id)
            for c in d.children:
                visit(c, my_id)

        visit(root, -1)
        self.parent = np.asarray(parents, dtype=np.int32)
        #: per-domain tree depth (root = 0), preorder-indexed
        self.depth = np.zeros(len(self.domains), dtype=np.int32)
        for i in range(1, len(self.domains)):
            self.depth[i] = self.depth[self.parent[i]] + 1
        self.leaf_ids = np.array(
            [i for i, d in enumerate(self.domains) if d.is_leaf],
            dtype=np.int32,
        )

        # flatten leaf ranges, sorted by lo, and check disjointness
        spans = [
            (lo, hi, i)
            for i in self.leaf_ids
            for lo, hi in self.domains[i].nodes
        ]
        spans.sort()
        for (lo0, hi0, i0), (lo1, hi1, i1) in zip(spans, spans[1:]):
            if lo1 < hi0:
                raise ValueError(
                    f"node ranges overlap: [{lo0}, {hi0}) of "
                    f"{self.domains[i0].name!r} and [{lo1}, {hi1}) of "
                    f"{self.domains[i1].name!r}"
                )
        self._span_lo = np.array([s[0] for s in spans], dtype=np.int64)
        self._span_hi = np.array([s[1] for s in spans], dtype=np.int64)
        self._span_leaf = np.array([s[2] for s in spans], dtype=np.int32)
        #: node count the leaf ranges were validated to cover (None = unchecked)
        self.n_nodes = n_nodes
        if n_nodes is not None:
            self._validate_coverage(n_nodes)

    def _validate_coverage(self, n_nodes: int) -> None:
        """Leaf ranges must tile ``[0, n_nodes)`` exactly: no gaps between
        consecutive (sorted, already disjoint) spans, starting at 0 and
        ending at ``n_nodes``."""
        if n_nodes <= 0:
            raise ValueError(f"n_nodes must be positive, got {n_nodes}")
        if not len(self._span_lo):
            raise ValueError("topology has no leaf node ranges")
        if self._span_lo[0] != 0:
            raise ValueError(
                f"leaf ranges leave nodes [0, {self._span_lo[0]}) uncovered"
            )
        gaps = np.flatnonzero(self._span_lo[1:] != self._span_hi[:-1])
        if len(gaps):
            i = int(gaps[0])
            raise ValueError(
                f"leaf ranges leave nodes [{self._span_hi[i]}, "
                f"{self._span_lo[i + 1]}) uncovered"
            )
        if self._span_hi[-1] != n_nodes:
            raise ValueError(
                f"leaf ranges cover [0, {self._span_hi[-1]}) but "
                f"n_nodes={n_nodes}"
            )

    def __len__(self) -> int:
        return len(self.domains)

    def __iter__(self) -> Iterator[PowerDomain]:
        return iter(self.domains)

    @property
    def names(self) -> list[str]:
        return [d.name for d in self.domains]

    def leaf_of(self, node_ids) -> np.ndarray:
        """Vectorized node id → owning-leaf domain id.

        One ``searchsorted`` over the sorted range bounds; raises on any id
        no leaf owns.
        """
        ids = np.asarray(node_ids, dtype=np.int64)
        pos = np.searchsorted(self._span_lo, ids, side="right") - 1
        bad = (pos < 0) | (ids >= self._span_hi[np.clip(pos, 0, None)])
        if bad.any():
            orphan = ids[bad][:5].tolist()
            raise ValueError(f"node ids {orphan} outside every leaf domain")
        return self._span_leaf[pos]

    def owns(self, node_id: int) -> bool:
        try:
            self.leaf_of([node_id])
            return True
        except ValueError:
            return False

    def require_leaf(self, name: str) -> int:
        """Domain id of leaf ``name``; raises on unknown or non-leaf names.
        The one arrival-placement validator shared by scenario build-time
        checks and the engine's event application."""
        i = self.index.get(name)
        if i is None or not self.domains[i].is_leaf:
            raise ValueError(f"unknown or non-leaf domain {name!r}")
        return i

    def cap_at(self, r: int, overrides: dict | None = None) -> np.ndarray:
        """Per-domain caps at round ``r`` (preorder), with id-keyed
        ``overrides`` (e.g. persisted ``DomainCapChange`` events) applied."""
        caps = np.array(
            [d.cap_at(r) for d in self.domains], dtype=np.float64
        )
        for i, cap in (overrides or {}).items():
            caps[i] = cap
        return caps

    def aggregate_leaves(self, leaf_values: np.ndarray) -> np.ndarray:
        """Sum per-leaf values up the tree → per-domain totals (preorder).

        ``leaf_values`` is indexed by domain id (non-leaf slots ignored);
        one reverse-preorder sweep accumulates children into parents.
        """
        out = np.zeros(len(self.domains), dtype=np.float64)
        out[self.leaf_ids] = np.asarray(leaf_values, dtype=np.float64)[
            self.leaf_ids
        ]
        for i in range(len(self.domains) - 1, 0, -1):
            out[self.parent[i]] += out[i]
        return out

    def derate_factors(
        self, spend: np.ndarray, allowed: np.ndarray
    ) -> np.ndarray:
        """Per-domain effective derate factor clawing spend back under caps.

        ``spend``/``allowed`` are preorder-indexed per-domain totals (spend
        already aggregated up the tree).  A domain's own factor is
        ``min(1, allowed/spend)``; the *effective* factor also honours every
        ancestor (a rack inside an over-drawn room must derate too), so one
        preorder pass takes ``min(own, parent_effective)`` — parents precede
        children in preorder.  Scaling each leaf's spend by its effective
        factor guarantees every domain's total lands at or under ``allowed``
        (spend aggregates linearly, and factors only shrink down the tree).
        """
        spend = np.asarray(spend, dtype=np.float64)
        allowed = np.asarray(allowed, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            own = np.where(
                spend > allowed, np.divide(allowed, np.maximum(spend, 1e-300)), 1.0
            )
        own = np.clip(np.where(np.isfinite(own), own, 1.0), 0.0, 1.0)
        eff = own.copy()
        for i in range(1, len(self.domains)):
            eff[i] = min(eff[i], eff[self.parent[i]])
        return eff

    # -- builders ------------------------------------------------------------

    @staticmethod
    def single_root(
        n_nodes: int, cap: CapTrace, name: str = "cluster"
    ) -> "PowerTopology":
        """Degenerate topology: one domain owning every node — the parity
        anchor (hierarchical solve == flat grouped solve, bit-for-bit)."""
        return PowerTopology(
            PowerDomain(name=name, cap=cap, nodes=((0, n_nodes),))
        )

    @staticmethod
    def uniform_racks(
        n_nodes: int,
        n_racks: int,
        rack_cap: CapTrace,
        site_cap: CapTrace | None = None,
        name: str = "site",
    ) -> "PowerTopology":
        """Two-level site → rack tree with contiguous equal node ranges.

        ``site_cap`` defaults to unconstrained at the root (1e18 W), i.e.
        only the rack/PDU caps bind.
        """
        if not 1 <= n_racks <= n_nodes:
            raise ValueError(f"need 1 <= n_racks={n_racks} <= n_nodes={n_nodes}")
        bounds = np.linspace(0, n_nodes, n_racks + 1).astype(int)
        racks = tuple(
            PowerDomain(
                name=f"rack{k}",
                cap=rack_cap,
                nodes=((int(bounds[k]), int(bounds[k + 1])),),
            )
            for k in range(n_racks)
        )
        return PowerTopology(
            PowerDomain(
                name=name,
                cap=1e18 if site_cap is None else site_cap,
                children=racks,
            ),
            n_nodes=n_nodes,
        )

    #: default level names for :meth:`uniform_tree` (depth below the root)
    LEVEL_NAMES = ("row", "pdu", "chassis", "rack", "shelf")

    @staticmethod
    def uniform_tree(
        n_nodes: int,
        fanouts: Sequence[int],
        caps: Sequence[CapTrace],
        name: str = "site",
        level_names: Sequence[str] | None = None,
    ) -> "PowerTopology":
        """Balanced arbitrary-depth tree: site → row → PDU → ... → leaf.

        ``fanouts[d]`` is the child count of every level-``d`` domain, so
        the tree has ``len(fanouts) + 1`` levels and ``prod(fanouts)``
        leaves; ``caps[0]`` is the root cap and ``caps[d + 1]`` the cap
        trace shared by every level-``d+1`` domain (any :data:`CapTrace`
        form, including a ``BudgetProvider``).  Leaves own contiguous,
        near-equal node ranges tiling ``[0, n_nodes)`` exactly —
        coverage-validated at build time.  Level names default to
        :data:`LEVEL_NAMES` (``site → row → pdu → ...``); domain ``k`` at
        level ``d`` is named ``f"{level_names[d - 1]}{k}"``.
        """
        fanouts = [int(f) for f in fanouts]
        if not fanouts or any(f < 1 for f in fanouts):
            raise ValueError(f"fanouts must be positive, got {fanouts}")
        if len(caps) != len(fanouts) + 1:
            raise ValueError(
                f"need len(caps) == len(fanouts) + 1 (root + one per "
                f"level), got {len(caps)} caps for {len(fanouts)} fanouts"
            )
        n_leaves = int(np.prod(fanouts))
        if not 1 <= n_leaves <= n_nodes:
            raise ValueError(
                f"need 1 <= prod(fanouts)={n_leaves} <= n_nodes={n_nodes}"
            )
        if level_names is None:
            level_names = [
                PowerTopology.LEVEL_NAMES[d]
                if d < len(PowerTopology.LEVEL_NAMES)
                else f"l{d + 1}"
                for d in range(len(fanouts))
            ]
        if len(level_names) != len(fanouts):
            raise ValueError("need one level name per fanout level")
        bounds = np.linspace(0, n_nodes, n_leaves + 1).astype(int)
        counters = [0] * len(fanouts)
        next_leaf = [0]

        def build(depth: int) -> PowerDomain:
            k = counters[depth - 1]
            counters[depth - 1] += 1
            if depth == len(fanouts):
                lo, hi = int(bounds[next_leaf[0]]), int(bounds[next_leaf[0] + 1])
                next_leaf[0] += 1
                return PowerDomain(
                    name=f"{level_names[depth - 1]}{k}",
                    cap=caps[depth],
                    nodes=((lo, hi),),
                )
            return PowerDomain(
                name=f"{level_names[depth - 1]}{k}",
                cap=caps[depth],
                children=tuple(
                    build(depth + 1) for _ in range(fanouts[depth])
                ),
            )

        root = PowerDomain(
            name=name,
            cap=caps[0],
            children=tuple(build(1) for _ in range(fanouts[0])),
        )
        return PowerTopology(root, n_nodes=n_nodes)
