"""The port's host sparse solvers and incremental controller against the
JAX package, bit for bit.

Both packages get the same inputs: option tables made from a seed with
numpy (the port's through ``repro_torch.interop``), and the same seeded
clusters and event storms.  The sparse solvers are float64 numpy in both
packages, carried over as is, so every comparison is exact: picks, total
value and spent compare with ``==``, curves and keys as raw bytes.
"""

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import scenario as jscenario
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import curves as jcurves
from repro.core import mckp as jmckp
from repro.core import policies as jpolicies
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch import interop
from repro_torch.cluster import ClusterSim
from repro_torch.cluster import scenario as tscenario
from repro_torch.cluster.controller import make_controller
from repro_torch.core import mckp, policies, surfaces, types

# the shapes here are tiny: one intra-op thread keeps this file from
# crowding the other test workers' cores
torch.set_num_threads(1)
CPU = "cpu"


def _random_groups(rng: np.random.Generator, budget: float):
    """The behaviour classes of tests/test_grouped_alloc.py (interleaved
    member names, an occasional byte-identical duplicate table) as
    (reference groups, port groups); the port's come through
    ``interop.grouped_options_from_arrays``."""
    n_groups = int(rng.integers(1, 6))
    sizes = [int(rng.integers(1, 8)) for _ in range(n_groups)]
    slots: list[int] = []
    for g, m in enumerate(sizes):
        slots += [g] * m
    rng.shuffle(slots)
    members: dict[int, list[str]] = {g: [] for g in range(n_groups)}
    for i, g in enumerate(slots):
        members[g].append(f"x{i:03d}")
    jg = []
    for g in range(n_groups):
        k = int(rng.integers(1, 7))
        costs = np.unique(
            rng.integers(1, max(2, int(budget / 25)), size=k)
        ).astype(float) * 25.0
        values = np.sort(rng.uniform(0.01, 0.5, size=len(costs)))
        caps = np.stack([100.0 + costs, np.full_like(costs, 100.0)], axis=-1)
        table = jcurves.OptionTable(
            name=f"class{g}",
            costs=np.concatenate([[0.0], costs]),
            values=np.concatenate([[0.0], values]),
            caps=np.concatenate([[[100.0, 100.0]], caps], axis=0),
        )
        jg.append(jmckp.GroupedOptions(table=table, members=tuple(sorted(members[g]))))
    if n_groups >= 2 and rng.random() < 0.4:
        t0 = jg[0].table
        dup = jcurves.OptionTable(
            name="dup", costs=t0.costs.copy(), values=t0.values.copy(),
            caps=t0.caps.copy(),
        )
        jg[1] = jmckp.GroupedOptions(table=dup, members=jg[1].members)
    return jg, _port_groups(jg)


def _port_groups(jg):
    return interop.grouped_options_from_arrays(
        [(g.table.name, g.table.costs, g.table.values, g.table.caps, g.members)
         for g in jg]
    )


def _random_options(rng: np.random.Generator, n_apps: int, budget: float):
    """The option tables of tests/test_mckp.py (integer costs) as
    (reference tables, port tables)."""
    jopts = []
    for i in range(n_apps):
        k = int(rng.integers(1, 7))
        costs = np.unique(rng.integers(1, max(2, int(budget)), size=k)).astype(float)
        values = np.sort(rng.uniform(0.01, 0.5, size=len(costs)))
        caps = np.stack([100.0 + costs, np.full_like(costs, 100.0)], axis=-1)
        jopts.append(
            jcurves.OptionTable(
                name=f"app{i}",
                costs=np.concatenate([[0.0], costs]),
                values=np.concatenate([[0.0], values]),
                caps=np.concatenate([[[100.0, 100.0]], caps], axis=0),
            )
        )
    topts = [
        interop.option_table_from_arrays(o.name, o.costs, o.values, o.caps)
        for o in jopts
    ]
    return jopts, topts


def _assert_solution_equal(got, want):
    # bitwise: the same float64 numpy operations in the same order
    assert got.picks == want.picks
    assert got.total_value == want.total_value
    assert got.spent == want.spent


# ---------------------------------------------------------------------------
# Solvers on the shapes of tests/test_grouped_alloc.py and tests/test_mckp.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_sparse_solvers_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        budget = float(rng.integers(3, 40)) * 25.0
        jg, tg = _random_groups(rng, budget)
        want = jmckp.solve_sparse_grouped(jg, budget)
        _assert_solution_equal(mckp.solve_sparse_grouped(tg, budget), want)
        _assert_solution_equal(mckp.solve_grouped(tg, budget, device=CPU), want)
        _assert_solution_equal(
            mckp.solve_sparse(mckp.expand_groups(tg), budget),
            jmckp.solve_sparse(jmckp.expand_groups(jg), budget),
        )


@pytest.mark.parametrize("seed", range(6))
def test_brute_force_and_sparse_match_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        budget = float(rng.integers(5, 60))
        jopts, topts = _random_options(rng, int(rng.integers(1, 6)), budget)
        want_bf = jmckp.brute_force(jopts, budget)
        got_bf = mckp.brute_force(topts, budget)
        _assert_solution_equal(got_bf, want_bf)
        _assert_solution_equal(
            mckp.solve_sparse(topts, budget), jmckp.solve_sparse(jopts, budget)
        )
        # the oracle: the DP reaches the brute-force optimum (to rounding)
        assert abs(mckp.solve_sparse(topts, budget).total_value - got_bf.total_value) <= 1e-9


def test_warm_caches_match_reference():
    """The same LRU-cached sequence of solves (drifting budgets, membership
    churn, a straggler-style duplicate) in both packages: every solution
    bitwise equal, and the caches end with the same keys."""
    rng = np.random.default_rng(77)
    jc = [jmckp.LRUCache(64) for _ in range(4)]
    tc = [mckp.LRUCache(64) for _ in range(4)]
    jg, tg = _random_groups(rng, 800.0)
    for step in range(12):
        budget = 800.0 - 37.5 * step
        if step % 4 == 3:  # membership churn: drop one member of class 0
            members = jg[0].members[1:] or jg[0].members
            jg[0] = jmckp.GroupedOptions(table=jg[0].table, members=members)
            tg[0] = mckp.GroupedOptions(table=tg[0].table, members=members)
        kw = lambda c: dict(  # noqa: E731
            curve_cache=c[0], pick_cache=c[1], plan_cache=c[2], chain_cache=c[3]
        )
        _assert_solution_equal(
            mckp.solve_sparse_grouped(tg, budget, **kw(tc)),
            jmckp.solve_sparse_grouped(jg, budget, **kw(jc)),
        )
    # curve and pick keys are content keys: equal across the packages
    assert list(tc[0]) == list(jc[0])
    assert list(tc[1]) == list(jc[1])


def test_lru_cache_matches_reference():
    a, b = mckp.LRUCache(3), jmckp.LRUCache(3)
    for c in (a, b):
        for k in "abcd":
            c[k] = k
        c.get("b")
        c["e"] = "e"
        c.resize(2)
    # (iterating items() through __getitem__ would refresh recency)
    assert list(a._d.items()) == list(b._d.items()) == [("b", "b"), ("e", "e")]
    with pytest.raises(ValueError):
        mckp.LRUCache(0)


@pytest.mark.parametrize("seed", range(4))
def test_maxplus_pair_matches_reference(seed):
    """The (max,+) pair primitive on the integer lattice (dense gather path)
    and off it (lexsort path): keys, values and splits as raw bytes."""
    rng = np.random.default_rng(seed)
    for lattice in (True, False):
        n_a, n_b = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        if lattice:
            a_keys = np.unique(rng.integers(0, 400, n_a)) * 25.0
            b_keys = np.unique(rng.integers(0, 400, n_b)) * 25.0
        else:
            a_keys = np.unique(rng.uniform(0, 9000, n_a).round(3))
            b_keys = np.unique(rng.uniform(0, 9000, n_b).round(3))
        a_vals = np.round(rng.uniform(0, 2, len(a_keys)) * 4) / 4  # ties
        b_vals = np.round(rng.uniform(0, 2, len(b_keys)) * 4) / 4
        a_keys, b_keys = jmckp._qkey_np(a_keys), jmckp._qkey_np(b_keys)
        budget = 6000.0
        got = mckp._maxplus_pair(a_keys, a_vals, b_keys, b_vals, budget)
        want = jmckp._maxplus_pair(a_keys, a_vals, b_keys, b_vals, budget)
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_superstage_dp_batch_matches_reference(seed):
    """The batched integer-lattice super-stage DP over several leaves:
    frontier keys/values and every backtrack bitwise the reference's."""
    rng = np.random.default_rng(50 + seed)
    jobs_j, jobs_t = [], []
    for _ in range(3):
        budget = float(rng.integers(8, 30)) * 25.0
        jg, tg = _random_groups(rng, budget)
        for groups, m, jobs in ((jg, jmckp, jobs_j), (tg, mckp, jobs_t)):
            plan = m._leaf_plan(groups)
            cvs, _ = m._class_curves(plan.classes, budget, None)
            jobs.append(([(c.keys, c.vals) for c in cvs], budget))
    got = mckp._superstage_dp_batch(jobs_t)
    want = jmckp._superstage_dp_batch(jobs_j)
    assert got is not None and want is not None
    for (gk, gv, gs), (wk, wv, ws) in zip(got, want):
        assert gk.tobytes() == wk.tobytes() and gv.tobytes() == wv.tobytes()
        for u in gk:
            assert mckp._backtrack_superstages(gs, float(u)) == (
                jmckp._backtrack_superstages(ws, float(u))
            )
    # and each leaf equals its own per-leaf sparse super-stage DP
    for (gk, gv, _), (stages, budget) in zip(got, jobs_t):
        k1, v1, _ = mckp._superstage_dp(stages, budget)
        assert gk.tobytes() == k1.tobytes() and gv.tobytes() == v1.tobytes()


def test_interop_groups_reject_bad_arrays():
    z = np.zeros(2)
    with pytest.raises(ValueError, match="zero-cost"):
        interop.option_table_from_arrays("t", z + 1.0, z, np.zeros((2, 2)))
    with pytest.raises(ValueError, match="caps"):
        interop.option_table_from_arrays("t", z, z, np.zeros((3, 2)))
    (g,) = interop.grouped_options_from_arrays([("t", z, z, np.zeros((2, 2)), ["b", "a"])])
    assert g.members == ("b", "a") and g.table.costs.dtype == np.float64


# ---------------------------------------------------------------------------
# The sparse policy and the incremental controller
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


def test_sparse_policy_matches_reference(suites):
    (japps, jsurfs), (tapps, tsurfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=24, seed=3)
    tsim = ClusterSim.build(types.SYSTEM_1, tapps, tsurfs, n_nodes=24, seed=3, device=CPU)
    _, jrecv, _ = jsim.partition()
    _, trecv, _ = tsim.partition()
    for grouped in (True, False):
        want = jpolicies.ecoshift(
            [n.app for n in jrecv], {n.app.name: n.caps for n in jrecv}, 700.0,
            jtypes.SYSTEM_1, {n.app.name: jsim._surface(n) for n in jrecv},
            grouped=grouped,
        )
        got = policies.ecoshift(
            [n.app for n in trecv], {n.app.name: n.caps for n in trecv}, 700.0,
            types.SYSTEM_1, {n.app.name: tsim._surface(n) for n in trecv},
            grouped=grouped, device=CPU,
        )
        assert dict(got.caps) == dict(want.caps)
        assert got.spent == want.spent
        assert got.predicted_improvement == want.predicted_improvement


def _event_specs(rng, alive_ids, app_names, k):
    """k random (kind, node, arg) events, as tests/test_incremental_alloc.py
    draws them: straggler onset, phase change or failure."""
    out = []
    for _ in range(k):
        kind = int(rng.integers(0, 3))
        v = int(rng.choice(alive_ids))
        if kind == 0:
            out.append(("straggler", v, float(rng.choice([1.0, 1.4, 1.9]))))
        elif kind == 1:
            out.append(("phase", v, app_names[int(rng.integers(len(app_names)))]))
        else:
            out.append(("failure", v, None))
    return out


def _events(sc, specs, r):
    """Instantiate event specs with one package's scenario classes."""
    out = []
    for kind, v, arg in specs:
        if kind == "straggler":
            out.append(sc.StragglerOnset(round=r, node_id=v, slowdown=arg))
        elif kind == "phase":
            out.append(sc.PhaseChange(round=r, node_id=v, surface_id=arg))
        else:
            out.append(sc.NodeFailure(round=r, node_ids=(v,)))
    return out


def run_storm_pair(suites, seed, churn, port_kw, *, n=48, n_rounds=6, budget0=1800.0):
    """One seeded event storm through a reference sim under its default
    (incremental host sparse) controller and a port sim under
    ``make_controller("ecoshift", **port_kw)``; the budget drifts -25 W a
    round so event-free rounds still solve.  Asserts every round's
    allocation bitwise equal and returns (port controller, per-round
    (port last_solver, reference last_solver))."""
    (japps, jsurfs), (tapps, tsurfs) = suites
    japps, tapps = japps[:8], tapps[:8]
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=0,
                      initial_caps=(150.0, 150.0))
    tsim = ClusterSim.build(types.SYSTEM_1, tapps, tsurfs, n_nodes=n, seed=0,
                            initial_caps=(150.0, 150.0), device=CPU)
    jctrl = j_make_controller("ecoshift", jtypes.SYSTEM_1)
    tctrl = make_controller("ecoshift", types.SYSTEM_1, device=CPU, **port_kw)
    rng = np.random.default_rng(seed)
    k = int(np.ceil(n * churn))
    solvers = []
    for r in range(n_rounds):
        specs = []
        if churn > 0 and r >= 1:
            alive = jsim.table.node_ids[jsim.table.alive]
            specs = _event_specs(rng, alive, [a.name for a in japps], k)
        budget = budget0 - 25.0 * r
        allocs = []
        for sim, ctrl, sc in ((tsim, tctrl, tscenario), (jsim, jctrl, jscenario)):
            if specs:
                ctrl.invalidate(sim.apply_events(_events(sc, specs, r)))
            allocs.append(sim.run_round(ctrl, budget=budget, round_index=r).allocation)
        got, want = allocs
        assert dict(got.caps) == dict(want.caps), f"seed {seed} round {r}"
        assert got.spent == want.spent
        assert got.predicted_improvement == want.predicted_improvement
        solvers.append((tctrl.last_solver, jctrl.last_solver))
    return tctrl, solvers


@pytest.mark.parametrize("churn", [0.0, 0.10])
@pytest.mark.parametrize("seed", range(2))
def test_incremental_controller_matches_reference(suites, seed, churn):
    _, solvers = run_storm_pair(suites, seed, churn, {})
    # the same rounds solve, and the same rounds hit the allocation cache
    assert [g for g, _ in solvers] == [w for _, w in solvers]


def test_incremental_controller_reuses_unchanged_round(suites):
    """An event-free round at an unchanged budget gets the engine's cached
    batch back and returns the cached Allocation object, as the reference
    does."""
    _, (tapps, tsurfs) = suites
    sim = ClusterSim.build(types.SYSTEM_1, tapps[:6], tsurfs, n_nodes=20, seed=0, device=CPU)
    ctrl = make_controller("ecoshift", types.SYSTEM_1, device=CPU)
    r0 = sim.run_round(ctrl, budget=900.0, round_index=0)
    b0 = ctrl._grouping.seq
    r1 = sim.run_round(ctrl, budget=900.0, round_index=1)
    assert r1.allocation is r0.allocation
    assert ctrl.last_solver == "cache" and ctrl._grouping.seq == b0
    ctrl2 = make_controller("ecoshift", types.SYSTEM_1, device=CPU, incremental=False)
    assert dict(sim.run_round(ctrl2, budget=900.0, round_index=2).allocation.caps) == dict(
        r0.allocation.caps
    )
    assert ctrl2.last_solver == "host"


def test_node_table_dirty_log():
    """bump/dirty_since: bounded deltas, None past the horizon or after an
    unbounded bump, as the reference's log."""
    from repro.cluster.sim import NodeTable as JTable
    from repro_torch.cluster.sim import NodeTable as TTable

    for cls in (TTable, JTable):
        t = cls()
        t.bump([3, 1])
        t.bump([1, 7])
        assert t.dirty_since(0).tolist() == [1, 3, 7]
        assert t.dirty_since(1).tolist() == [1, 7]
        assert t.dirty_since(2).tolist() == []
        assert t.dirty_since(5) is None
        t.bump()
        assert t.dirty_since(1) is None
        for _ in range(70):
            t.bump([0])
        assert t.dirty_since(3) is None
        assert t.dirty_since(t.version - 2).tolist() == [0]


def test_engine_batches_follow_the_delta_contract(suites):
    """The port's engine hands the controller the reference's batch chain:
    the same prev_seq links, deltas and removed names, round by round,
    under a failure, a straggler and an arrival."""
    (japps, jsurfs), (tapps, tsurfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=30, seed=0)
    tsim = ClusterSim.build(types.SYSTEM_1, tapps, tsurfs, n_nodes=30, seed=0, device=CPU)
    _, recv, _ = jsim.partition()
    rounds = [
        [],
        [("failure", recv[0].node_id, None)],
        [("straggler", recv[2].node_id, 1.7)],
        [],
        [("arrival", None, None)],
    ]
    chains = []
    for sim, sc, app in ((jsim, jscenario, japps[0]), (tsim, tscenario, tapps[0])):
        seqs, out = [], []
        for r, specs in enumerate(rounds):
            evs = []
            for kind, v, arg in specs:
                if kind == "arrival":
                    evs.append(sc.NodeArrival(round=r, app=app))
                else:
                    evs.extend(_events(sc, [(kind, v, arg)], r))
            if evs:
                sim.apply_events(evs)
            _, rows, _ = sim.partition_rows()
            b = sim._receiver_batch(rows, None, False)
            prev = seqs.index(b.prev_seq) if b.prev_seq in seqs else None
            if not seqs or b.seq != seqs[-1]:
                seqs.append(b.seq)
            out.append((len(seqs), prev, b.delta, b.removed, list(b.names)))
        chains.append(out)
    assert chains[0] == chains[1]
