"""The port's hierarchical power-domain path against the JAX package, bit
for bit.

* ``solve_hierarchical`` — sparse (numpy in both packages) and dense
  (``"jax"`` and ``"pallas"``: on the CPU the port's wrappers take the
  plain version, the reference runs its jnp scan and its Pallas kernel in
  interpret mode, both float32) — on tests/test_hier_alloc.py's
  ``_random_groups`` seeds, its multi-domain, three-level and empty-leaf
  cases: picks, total value, spent and every domain's spend with ``==``.
* The fused ``tree`` and ``leaf_root`` kinds (``device="cpu"``: the stage
  kernel's plain version) against the port's and the reference's host
  sparse solver on tests/test_deep_tree.py's ``_random_deep_tree`` seeds,
  which the reference certifies equal to its own fused path; one case
  holds them against the reference's fused path itself, run with
  ``jax.experimental.enable_x64`` aliased to ``jax.enable_x64`` (the name
  this jax version moved), the JAX package untouched.
* ``ClusterSim.run`` under ``ecoshift_hier`` (host, fused and dense)
  against the reference's records on tests/test_hier_alloc.py's engine
  scenarios and tests/test_deep_tree.py's deep event storm (seeds 0–2),
  ``domain_draw`` and ``domain_caps`` included.

Inputs come from numpy seeds (the reference tests' own generators); the
port's groups and topologies arrive through ``repro_torch.interop``.
Tolerance zero everywhere: both sides only add and compare.
"""

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import PowerTopology as JTopology
from repro.cluster import Scenario as JScenario
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import mckp as jmckp
from repro.core import policies as jpolicies
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch import interop
from repro_torch.cluster import ClusterSim, Scenario
from repro_torch.cluster.controller import make_controller
from repro_torch.cluster.predictor import OnlinePredictor, OnlinePredictorConfig
from repro_torch.core import curves, mckp, policies, surfaces, types
from test_deep_tree import _deep_engine_topology, _random_deep_tree
from test_hier_alloc import _random_domain_instance, _random_groups

torch.set_num_threads(1)
CPU = "cpu"


def _port_groups(jgroups):
    return interop.grouped_options_from_arrays(
        [(g.table.name, g.table.costs, g.table.values, g.table.caps, g.members)
         for g in jgroups]
    )


def _port_tree(jdom):
    """The port's DomainGroups tree of a reference one."""
    if jdom.children:
        return mckp.DomainGroups(
            name=jdom.name, cap=jdom.cap,
            children=tuple(_port_tree(c) for c in jdom.children),
        )
    return mckp.DomainGroups(
        name=jdom.name, cap=jdom.cap, groups=tuple(_port_groups(jdom.groups))
    )


def _assert_solution_equal(got, want):
    assert got.picks == want.picks
    assert got.total_value == want.total_value
    assert got.spent == want.spent
    assert got.domain_spent == want.domain_spent


# ---------------------------------------------------------------------------
# Host solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_single_root_sparse_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        budget = float(rng.integers(3, 40)) * 25.0
        jg = _random_groups(rng, budget)
        jroot = jmckp.DomainGroups(name="root", cap=budget, groups=tuple(jg))
        root = _port_tree(jroot)
        got = mckp.solve_hierarchical(root, budget)
        _assert_solution_equal(got, jmckp.solve_hierarchical(jroot, budget))
        flat = mckp.solve_sparse_grouped(_port_groups(jg), budget)
        assert (got.picks, got.total_value, got.spent) == (
            flat.picks, flat.total_value, flat.spent
        )


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_single_root_dense_matches_reference(backend):
    rng = np.random.default_rng(11)
    for _ in range(3):
        budget = float(rng.integers(3, 10)) * 25.0
        jg = _random_groups(rng, budget)
        jroot = jmckp.DomainGroups(name="root", cap=budget, groups=tuple(jg))
        got = mckp.solve_hierarchical(
            _port_tree(jroot), budget, solver=backend, device=CPU
        )
        _assert_solution_equal(
            got, jmckp.solve_hierarchical(jroot, budget, solver=backend)
        )
        flat = mckp.solve_dense_jax_grouped(
            _port_groups(jg), budget, backend=backend, device=CPU
        )
        assert (got.picks, got.total_value, got.spent) == (
            flat.picks, flat.total_value, flat.spent
        )


@pytest.mark.parametrize("seed", range(12))
def test_multi_domain_matches_reference(seed):
    rng = np.random.default_rng(400 + seed)
    budget = float(rng.integers(4, 12)) * 25.0
    _, jroot = _random_domain_instance(rng, budget)
    root = _port_tree(jroot)
    for solver in ("sparse", "jax"):
        got = mckp.solve_hierarchical(root, budget, solver=solver, device=CPU)
        _assert_solution_equal(got, jmckp.solve_hierarchical(jroot, budget, solver=solver))
        for kid in root.children:
            assert got.domain_spent[kid.name] <= kid.cap + 1e-6


def _three_level(mod, gA, gB):
    row = mod.DomainGroups(name="row", cap=75.0, children=(
        mod.DomainGroups(name="r0", cap=50.0, groups=(gA,)),
        mod.DomainGroups(name="r1", cap=75.0, groups=(gB,)),
    ))
    return mod.DomainGroups(name="site", cap=500.0, children=(
        row, mod.DomainGroups(name="empty", cap=100.0),
    ))


@pytest.mark.parametrize("solver", ["sparse", "jax", "pallas"])
def test_three_level_and_empty_leaf_match_reference(solver):
    rng = np.random.default_rng(77)
    jA = _random_groups(rng, 500.0, n_groups=1, prefix="a")[0]
    jB = _random_groups(rng, 500.0, n_groups=1, prefix="b")[0]
    (tA,), (tB,) = _port_groups([jA]), _port_groups([jB])
    want = jmckp.solve_hierarchical(_three_level(jmckp, jA, jB), 500.0, solver=solver)
    got = mckp.solve_hierarchical(
        _three_level(mckp, tA, tB), 500.0, solver=solver, device=CPU
    )
    _assert_solution_equal(got, want)
    assert got.domain_spent["empty"] == 0.0
    assert got.domain_spent["row"] <= 75.0 + 1e-6


@pytest.mark.parametrize("nb,special", [
    (3001, "ties"), (5120, "signed_zeros"), (8001, "sparse"),
])
def test_stage_maxplus_full_grid_matches_reference_tile(nb, special):
    """The dense frontier combine's stage (:func:`mckp._conv_full`: every
    grid spend an option) against the reference's [k, b] tile bit for bit,
    values and first-max picks, at the widths of the rack tier's root grid:
    quarter-watt values with exact ties everywhere, -inf tails on both
    operands, signed zeros, and mostly unreachable (-inf) spends."""
    rng = np.random.default_rng(nb)

    def frontier(support):
        x = np.round(rng.uniform(0.0, 8.0, nb) * 4) / 4
        x[rng.random(nb) < 0.1] = -np.inf
        x[0] = 0.0
        x[support:] = -np.inf
        return x

    dp, f = frontier(int(nb * 0.6)), frontier(int(nb * 0.45))
    if special == "signed_zeros":
        dp[rng.random(nb) < 0.3] = -0.0
        f[rng.random(nb) < 0.3] = 0.0
        f[rng.random(nb) < 0.3] = -0.0
    elif special == "sparse":
        dp[1:][rng.random(nb - 1) < 0.7] = -np.inf
        f[1:][rng.random(nb - 1) < 0.7] = -np.inf
    got = mckp._conv_full(dp, f)
    want = jmckp._conv_full(dp, f)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    # and the option-cost form the leaf DPs take: a few grid-spread costs
    cu = np.sort(rng.choice(nb + 40, 24, replace=False)).astype(np.int64)
    vals = np.round(rng.uniform(0.0, 3.0, cu.size) * 2) / 2
    got = mckp._stage_maxplus(dp, cu, vals)
    want = jmckp._stage_maxplus(dp, cu, vals)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()


def test_warm_hier_state_matches_from_scratch():
    """A persistent HierState and standalone warm caches re-solve bit for
    bit; a changed leaf re-solves against the warm state as from scratch."""
    rng = np.random.default_rng(5)
    jroot, _ = _random_deep_tree(rng, 600.0, unconstrained_internal=False)
    root = _port_tree(jroot)
    want = jmckp.solve_hierarchical(jroot, 600.0)
    st = mckp.HierState()
    curve_cache: dict = {}
    frontier_cache: dict = {}
    for _ in range(2):
        _assert_solution_equal(mckp.solve_hierarchical(root, 600.0, state=st), want)
        _assert_solution_equal(
            mckp.solve_hierarchical(
                root, 600.0, curve_cache=curve_cache, frontier_cache=frontier_cache
            ),
            want,
        )
    assert curve_cache and frontier_cache and st.cache_sizes()["combines"]
    _assert_solution_equal(
        mckp.solve_hierarchical(root, 450.0, state=st),
        jmckp.solve_hierarchical(jroot, 450.0),
    )


# ---------------------------------------------------------------------------
# Fused tree and leaf-root kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_fused_tree_matches_host_solvers(seed):
    rng = np.random.default_rng(3000 + seed)
    budget = float(rng.integers(6, 30)) * 25.0
    jroot, _ = _random_deep_tree(
        rng, budget, unconstrained_internal=bool(rng.integers(0, 2))
    )
    root = _port_tree(jroot)
    want = jmckp.solve_hierarchical(jroot, budget)
    fstate = mckp.FusedState()
    got = mckp.solve_hierarchical_fused(
        root, budget, state=mckp.HierState(), fstate=fstate, device=CPU
    )
    assert got is not None, fstate.stats["fallback_reason"]
    assert fstate.stats["fallback_reason"] == ""
    assert fstate.shape[0] == "tree"
    _assert_solution_equal(got, want)
    _assert_solution_equal(mckp.solve_hierarchical(root, budget), want)


@pytest.mark.parametrize("seed", range(4))
def test_fused_leaf_root_matches_host_solvers(seed):
    rng = np.random.default_rng(seed)
    budget = float(rng.integers(3, 40)) * 25.0
    jg = _random_groups(rng, budget)
    jroot = jmckp.DomainGroups(name="root", cap=budget * 0.8, groups=tuple(jg))
    fstate = mckp.FusedState()
    got = mckp.solve_hierarchical_fused(
        _port_tree(jroot), budget, state=mckp.HierState(), fstate=fstate, device=CPU
    )
    assert got is not None, fstate.stats["fallback_reason"]
    assert fstate.shape[0] == "leaf_root"
    _assert_solution_equal(got, jmckp.solve_hierarchical(jroot, budget))
    assert got.domain_spent == {"root": got.domain_spent["root"]}


def test_fused_warm_resolve_stays_bitwise():
    """Re-solving a deep tree against resident banks stays bit for bit, and
    a budget change rides the same banks."""
    rng = np.random.default_rng(99)
    jroot, _ = _random_deep_tree(rng, 600.0, unconstrained_internal=False)
    root = _port_tree(jroot)
    state, fstate = mckp.HierState(), mckp.FusedState()
    for b in (600.0, 600.0, 500.0):
        got = mckp.solve_hierarchical_fused(
            root, b, state=state, fstate=fstate, device=CPU
        )
        assert got is not None, fstate.stats["fallback_reason"]
        _assert_solution_equal(got, jmckp.solve_hierarchical(jroot, b))
    assert fstate.stats["fallbacks"] == 0
    assert fstate.stats["rebuilds"] == 1
    assert fstate.stats["short_circuits"] == 1


def test_fused_fallback_reasons():
    """The reference's fallbacks and their reasons (test_deep_tree.py's
    ``test_fused_fallback_reasons``), and a structure change against
    resident banks served fused."""

    def one_leaf_root(costs, cap, budget):
        t = curves.OptionTable(
            name="odd",
            costs=np.asarray(costs, dtype=float),
            values=np.linspace(0.0, 0.5, len(costs)),
            caps=np.stack([100.0 + np.asarray(costs, dtype=float),
                           np.full(len(costs), 100.0)], axis=-1),
        )
        g = mckp.GroupedOptions(table=t, members=("n0",))
        return mckp.DomainGroups(name="site", cap=budget, children=(
            mckp.DomainGroups(name="r0", cap=cap, groups=(g,)),
        ))

    fstate = mckp.FusedState()
    out = mckp.solve_hierarchical_fused(
        one_leaf_root([0.0, 25.0, 150000.0], 1e18, 200000.0), 200000.0,
        state=mckp.HierState(), fstate=fstate, device=CPU,
    )
    assert out is None and fstate.stats["fallback_reason"] == "grid_overflow"
    assert mckp._fused_run(
        [], "tree", None, (), pick_cache=None, fstate=fstate,
        device=torch.device(CPU),
    ) is None
    assert fstate.stats["fallback_reason"] == "empty"

    rng = np.random.default_rng(7)
    tree_a, _ = _random_deep_tree(rng, 500.0)
    tree_b, _ = _random_deep_tree(rng, 500.0)
    state, fstate = mckp.HierState(), mckp.FusedState()
    assert mckp.solve_hierarchical_fused(
        _port_tree(tree_a), 500.0, state=state, fstate=fstate, device=CPU
    ) is not None
    out = mckp.solve_hierarchical_fused(
        _port_tree(tree_b), 500.0, state=mckp.HierState(), fstate=fstate, device=CPU
    )
    assert out is not None
    assert fstate.stats["fallbacks"] == 0
    assert fstate.stats["rebuilds"] == 1 and fstate.stats["compactions"] == 1
    _assert_solution_equal(out, jmckp.solve_hierarchical(tree_b, 500.0))


@pytest.mark.parametrize("seed", [0, 5])
def test_fused_tree_matches_reference_fused_path(monkeypatch, seed):
    """Direct fused-against-fused: the reference's own fused round, run in
    interpret mode with ``jax.experimental.enable_x64`` aliased to
    ``jax.enable_x64`` (the reference's fused path needs the former, which
    this jax version moved), against the port's."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    rng = np.random.default_rng(3000 + seed)
    budget = float(rng.integers(6, 30)) * 25.0
    jroot, _ = _random_deep_tree(rng, budget, unconstrained_internal=False)
    jf = jmckp.FusedState()
    want = jmckp.solve_hierarchical_fused(
        jroot, budget, state=jmckp.HierState(), fstate=jf
    )
    fstate = mckp.FusedState()
    got = mckp.solve_hierarchical_fused(
        _port_tree(jroot), budget, state=mckp.HierState(), fstate=fstate, device=CPU
    )
    assert want is not None and got is not None
    _assert_solution_equal(got, want)
    assert fstate.shape[:6] == jf.shape[:6]
    assert not jax.config.jax_enable_x64


# ---------------------------------------------------------------------------
# Engine: ClusterSim.run under ecoshift_hier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


def _assert_records_equal(got, want):
    assert len(got.records) == len(want.records)
    for rg, rw in zip(got.records, want.records):
        ag, aw = rg.result.allocation, rw.result.allocation
        assert dict(ag.caps) == dict(aw.caps), rg.round
        assert ag.spent == aw.spent
        assert ag.predicted_improvement == aw.predicted_improvement
        assert rg.result.improvements == rw.result.improvements
        assert rg.pool == rw.pool and rg.n_alive == rw.n_alive
        assert rg.domain_draw == rw.domain_draw, rg.round
        assert rg.domain_caps == rw.domain_caps


def _scen_pair(n_rounds, budget, jtopo, topo, events):
    """(reference, port) scenarios with the same topology and events, given
    as (builder name, args) pairs."""
    js = JScenario.constant(n_rounds, budget=budget).with_topology(jtopo)
    ts = Scenario.constant(n_rounds, budget=budget).with_topology(topo)
    for name, args in events:
        js = getattr(js, name)(*args)
        ts = getattr(ts, name)(*args)
    return js, ts


def _run_pair(suites, n, seed, jtopo, scens, port_kw, j_kw=None, initial=(150.0, 150.0)):
    (japps, jsurfs), (apps, surfs) = suites
    js, ts = scens
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=seed,
                      initial_caps=initial, topology=jtopo)
    want = jsim.run(js, j_make_controller("ecoshift_hier", jtypes.SYSTEM_1, **(j_kw or {})))
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=seed,
                           initial_caps=initial, topology=ts.topology, device=CPU)
    ctrl = make_controller("ecoshift_hier", types.SYSTEM_1, device=CPU, **port_kw)
    got = sim.run(ts, ctrl)
    return got, want, ctrl, sim


PORT_MODES = {
    "host": ({}, None),
    "fused": ({"fused": True}, None),
    "dense": ({"solver": "jax"}, {"solver": "jax"}),
}


@pytest.mark.parametrize("mode", list(PORT_MODES))
@pytest.mark.parametrize("seed", range(4))
def test_randomized_rack_scenarios_match_reference(suites, seed, mode):
    """tests/test_hier_alloc.py's randomized binding-rack scenarios: the
    port's records equal the reference's, and every domain stays at or
    under its cap in every round."""
    rng = np.random.default_rng(seed)
    n = 60
    n_racks = int(rng.integers(2, 5))
    rack_committed = 300.0 * n / n_racks
    rack_cap = rack_committed + float(rng.integers(2, 8)) * 50.0
    site_cap = 300.0 * n + float(rng.integers(2, 8)) * 100.0
    jtopo = JTopology.uniform_racks(n, n_racks, rack_cap=rack_cap, site_cap=site_cap)
    topo = interop.topology_from_parts(jtopo)
    budget = float(rng.integers(5, 30)) * 100.0
    events = [
        ("with_failure", (1, *rng.choice(n, size=3, replace=False).tolist())),
        ("with_straggler", (2, int(rng.integers(0, n)), 1.6)),
        ("with_domain_cap", (3, f"rack{rng.integers(0, n_racks)}", rack_committed + 50.0)),
    ]
    port_kw, j_kw = PORT_MODES[mode]
    got, want, ctrl, _ = _run_pair(
        suites, n, seed, jtopo, _scen_pair(5, budget, jtopo, topo, events), port_kw, j_kw
    )
    _assert_records_equal(got, want)
    for rec in got.records:
        for name, draw in rec.domain_draw.items():
            assert draw <= rec.domain_caps[name] + 1e-6
    if mode == "fused":
        assert ctrl.fused_stats().fallbacks == 0 and ctrl.fused_stats().rounds > 0


@pytest.mark.parametrize("mode", list(PORT_MODES))
@pytest.mark.parametrize("seed", range(3))
def test_deep_event_storm_matches_reference(suites, seed, mode):
    """tests/test_deep_tree.py's deep event storm (a 4-level tree with
    binding caps at every level; failures, a straggler, a PDU derating)
    plus an arrival replacing a failed node on its chassis: records equal
    the reference's,
    every domain at or under its cap and every ancestor its children's
    sum."""
    (japps, jsurfs), _ = suites
    rng = np.random.default_rng(500 + seed)
    n = 48
    jtopo = _deep_engine_topology(jtypes.SYSTEM_1, japps, jsurfs, n, (2, 2, 2), rng, seed)
    topo = interop.topology_from_parts(jtopo)
    derate_dom = f"pdu{int(rng.integers(0, 4))}"
    derated = float(jtopo.domains[jtopo.index[derate_dom]].cap) - 25.0
    budget = float(rng.integers(4, 20)) * 100.0
    failed = rng.choice(n, size=3, replace=False).tolist()
    events = [
        ("with_failure", (1, *failed)),
        ("with_straggler", (2, int(rng.integers(0, n)), 1.6)),
        ("with_domain_cap", (3, derate_dom, derated)),
    ]
    port_kw, j_kw = PORT_MODES[mode]
    js, ts = _scen_pair(6, budget, jtopo, topo, events)
    # a replacement for the first failed node: its app on its leaf
    probe = ClusterSim.build(types.SYSTEM_1, suites[1][0], suites[1][1], n_nodes=n,
                             seed=seed, initial_caps=(150.0, 150.0), device=CPU)
    app = probe.table.strings[probe.table.base_gid[failed[0]]]
    leaf = jtopo.domains[int(jtopo.leaf_of([failed[0]])[0])].name
    js = js.with_arrival(4, next(a for a in japps if a.name == app),
                         caps=(150.0, 150.0), domain=leaf)
    ts = ts.with_arrival(4, next(a for a in suites[1][0] if a.name == app),
                         caps=(150.0, 150.0), domain=leaf)
    got, want, ctrl, _ = _run_pair(suites, n, seed, jtopo, (js, ts), port_kw, j_kw)
    _assert_records_equal(got, want)
    for rec in got.records:
        for name, draw in rec.domain_draw.items():
            assert draw <= rec.domain_caps[name] + 1e-6
        for dom in topo.domains:
            if not dom.is_leaf:
                kids = sum(rec.domain_draw[c.name] for c in dom.children)
                assert abs(rec.domain_draw[dom.name] - kids) <= 1e-6
    assert got.records[3].domain_caps[derate_dom] == derated
    if mode == "fused":
        stats = ctrl.fused_stats()
        assert stats.fallbacks == 0 and stats.rounds >= 5
        assert ctrl.last_domain_spent.keys() == set(topo.names)


def test_single_root_engine_parity(suites):
    """ecoshift_hier on a one-domain topology allocates like flat grouped
    ecoshift, round for round (the reference's test_single_root_engine_
    parity), and its records equal the reference's."""
    (japps, jsurfs), (apps, surfs) = suites
    n = 40
    jtopo = JTopology.single_root(n, cap=1e18)
    topo = interop.topology_from_parts(jtopo)
    events = [("with_failure", (1, 2, 5)), ("with_straggler", (2, 8, 1.8))]
    js, ts = _scen_pair(4, 1500.0, jtopo, topo, events)
    for port_kw in ({}, {"fused": True}):
        got, want, _, _ = _run_pair(suites, n, 0, jtopo, (js, ts), port_kw, initial=None)
        _assert_records_equal(got, want)
        flat_sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=0, device=CPU)
        flat = flat_sim.run(
            Scenario.constant(4, budget=1500.0).with_failure(1, 2, 5).with_straggler(2, 8, 1.8),
            make_controller("ecoshift", types.SYSTEM_1, device=CPU),
        )
        for rh, rf in zip(got.records, flat.records):
            assert dict(rh.result.allocation.caps) == dict(rf.result.allocation.caps)
            assert rh.result.allocation.spent == rf.result.allocation.spent


def test_domain_cap_change_binds_and_flat_controller_records(suites):
    """A mid-run rack derating constrains the derated rack (the reference's
    test_domain_cap_change_binds); a flat controller on a topology sim gets
    the accounting and overdraws a tight rack; explicit receivers commit
    their caps."""
    (japps, jsurfs), (apps, surfs) = suites
    n = 40
    probe = ClusterSim.build(
        types.SYSTEM_1, apps, surfs, n_nodes=n, seed=3, initial_caps=(150.0, 150.0),
        topology=topology_racks(n, 2, 1e15), device=CPU,
    )
    _, committed, _ = probe.domain_headroom(0)
    c0 = float(committed[1])
    cap0, derated = c0 + 150.0, c0 + 50.0
    jtopo = JTopology.uniform_racks(n, 2, rack_cap=cap0)
    topo = interop.topology_from_parts(jtopo)
    scens = _scen_pair(4, 2000.0, jtopo, topo, [("with_domain_cap", (2, "rack0", derated))])
    got, want, _, _ = _run_pair(suites, n, 3, jtopo, scens, {})
    _assert_records_equal(got, want)
    before, after = got.records[1], got.records[2]
    assert before.domain_caps["rack0"] == cap0 and after.domain_caps["rack0"] == derated
    assert before.domain_draw["rack0"] > derated >= after.domain_draw["rack0"] - 1e-6

    tight = topology_racks(n, 2, float(committed[1:].max()) + 25.0)
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=3,
                           initial_caps=(150.0, 150.0), topology=tight, device=CPU)
    sim.run_round(make_controller("ecoshift", types.SYSTEM_1, device=CPU), budget=2000.0)
    assert max(sim.last_domain_draw[k] - sim.last_domain_caps[k] for k in ("rack0", "rack1")) > 0
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=3,
                      initial_caps=(150.0, 150.0),
                      topology=JTopology.uniform_racks(n, 2, rack_cap=tight.domains[1].cap))
    jsim.run_round(j_make_controller("ecoshift", jtypes.SYSTEM_1), budget=2000.0)
    assert sim.last_domain_draw == jsim.last_domain_draw
    with pytest.raises(ValueError, match="attach a PowerTopology"):
        ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=3, device=CPU).run_round(
            make_controller("ecoshift_hier", types.SYSTEM_1, device=CPU), budget=100.0
        )


def topology_racks(n, n_racks, rack_cap):
    from repro_torch.cluster import PowerTopology

    return PowerTopology.uniform_racks(n, n_racks, rack_cap=rack_cap)


def test_warm_caches_and_pure_policy_match_reference(suites):
    """The controller keeps its warm tables and frontiers over an unchanged
    round (served from the allocation cache), and the pure
    ``policies.ecoshift_hier`` equals the controller and the reference's
    policy (sparse and dense)."""
    (japps, jsurfs), (apps, surfs) = suites
    n = 30
    jtopo = JTopology.uniform_racks(n, 3, rack_cap=9800.0, site_cap=29000.0)
    topo = interop.topology_from_parts(jtopo)
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=1,
                           initial_caps=(150.0, 150.0), topology=topo, device=CPU)
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=1,
                      initial_caps=(150.0, 150.0), topology=jtopo)
    ctrl = make_controller("ecoshift_hier", types.SYSTEM_1, device=CPU)
    got = sim.run_round(ctrl, budget=900.0)
    n_tables, n_frontiers = len(ctrl._group_tables), len(ctrl._frontiers)
    assert n_tables > 0 and n_frontiers > 0
    again = sim.run_round(ctrl, budget=900.0, round_index=1)
    assert ctrl.last_solver == "cache" and again.allocation is got.allocation
    assert (len(ctrl._group_tables), len(ctrl._frontiers)) == (n_tables, n_frontiers)

    for solver in ("sparse", "jax"):
        _, recv, _ = sim.partition()
        _, jrecv, _ = jsim.partition()
        extra, _, _ = sim.domain_headroom(0)
        kw = dict(
            node_of={nd.app.name: nd.node_id for nd in recv},
            domain_extra=dict(zip(topo.names, extra.tolist())), solver=solver,
        )
        want = jpolicies.ecoshift_hier(
            [nd.app for nd in jrecv], {nd.app.name: nd.caps for nd in jrecv}, 900.0,
            jtypes.SYSTEM_1, {nd.app.name: jsim._surface(nd) for nd in jrecv},
            topology=jtopo, **kw,
        )
        pol = policies.ecoshift_hier(
            [nd.app for nd in recv], {nd.app.name: nd.caps for nd in recv}, 900.0,
            types.SYSTEM_1, {nd.app.name: sim._surface(nd) for nd in recv},
            topology=topo, device=CPU, **kw,
        )
        assert dict(pol.caps) == dict(want.caps) and pol.spent == want.spent
        if solver == "sparse":
            assert dict(pol.caps) == dict(got.allocation.caps)
            assert pol.spent == got.allocation.spent
    # the standalone headroom approximation (no domain_extra)
    _, recv, _ = sim.partition()
    _, jrecv, _ = jsim.partition()
    want = jpolicies.ecoshift_hier(
        [nd.app for nd in jrecv], {nd.app.name: nd.caps for nd in jrecv}, 900.0,
        jtypes.SYSTEM_1, {nd.app.name: jsim._surface(nd) for nd in jrecv},
        topology=jtopo, node_of={nd.app.name: nd.node_id for nd in jrecv},
    )
    pol = policies.ecoshift_hier(
        [nd.app for nd in recv], {nd.app.name: nd.caps for nd in recv}, 900.0,
        types.SYSTEM_1, {nd.app.name: sim._surface(nd) for nd in recv},
        topology=topo, node_of={nd.app.name: nd.node_id for nd in recv},
    )
    assert dict(pol.caps) == dict(want.caps) and pol.spent == want.spent


class _StubNCF:
    def __init__(self, system):
        self.system = system
        self.app_index = {}


def test_predictor_backed_hier_controller_matches_reference(suites):
    """ecoshift_hier with a predictor serves its own surfaces (the engine
    hands it batches without true surfaces) and allocates as the
    reference's does."""
    from repro.cluster.predictor import OnlinePredictor as JOnline
    from repro.cluster.predictor import OnlinePredictorConfig as JOnlineConfig

    (japps, jsurfs), (apps, surfs) = suites
    n = 18
    jtopo = JTopology.uniform_racks(n, 2, rack_cap=6000.0)
    topo = interop.topology_from_parts(jtopo)
    jpred = JOnline(_StubNCF(jtypes.SYSTEM_1), JOnlineConfig())
    jpred.seed_surfaces(
        {a.name: jsurfaces.tabulate(jsurfs[a.name], jtypes.SYSTEM_1) for a in japps[:6]}
    )
    pred = OnlinePredictor(_StubNCF(types.SYSTEM_1), OnlinePredictorConfig())
    pred.seed_surfaces(
        {a.name: surfaces.tabulate(surfs[a.name], types.SYSTEM_1) for a in apps[:6]}
    )
    jsim = JSim.build(jtypes.SYSTEM_1, japps[:6], jsurfs, n_nodes=n, seed=1, topology=jtopo)
    sim = ClusterSim.build(types.SYSTEM_1, apps[:6], surfs, n_nodes=n, seed=1,
                           topology=topo, device=CPU)
    jctrl = j_make_controller("ecoshift_hier", jtypes.SYSTEM_1, predictor=jpred)
    ctrl = make_controller("ecoshift_hier", types.SYSTEM_1, predictor=pred, device=CPU)
    assert ctrl.serves_own_surfaces
    want = jsim.run_round(jctrl, budget=900.0)
    got = sim.run_round(ctrl, budget=900.0)
    assert dict(got.allocation.caps) == dict(want.allocation.caps)
    assert got.allocation.spent == want.allocation.spent
    assert got.improvements == want.improvements
    assert sim.last_domain_draw == jsim.last_domain_draw
    assert ctrl.last_domain_spent == jctrl.last_domain_spent
    for name, draw in sim.last_domain_draw.items():
        assert draw <= sim.last_domain_caps[name] + 1e-6


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_fused_tree_on_card_matches_host(cuda, seed):
    """The tree kind on the card (the leaf scan and every combine wave as
    stage-kernel launches) against the port's host solver, bit for bit."""
    from repro_torch.kernels import mckp_dp

    rng = np.random.default_rng(3000 + seed)
    budget = float(rng.integers(6, 30)) * 25.0
    jroot, _ = _random_deep_tree(rng, budget, unconstrained_internal=False)
    root = _port_tree(jroot)
    fstate = mckp.FusedState()
    mckp_dp.reset_launches()
    got = mckp.solve_hierarchical_fused(
        root, budget, state=mckp.HierState(), fstate=fstate, device=cuda
    )
    assert got is not None, fstate.stats["fallback_reason"]
    assert mckp_dp.launches["maxplus_stages_batched"] >= 2
    _assert_solution_equal(got, mckp.solve_hierarchical(root, budget))


@pytest.mark.gpu
def test_dense_hier_on_card_pallas_matches_jax(cuda):
    """The dense hierarchical solve on the card: kernel 2.2 (one launch a
    leaf-scan stage over every leaf, and the single-leaf scan) against its
    plain version, bit for bit."""
    from repro_torch.kernels import mckp_dp

    rng = np.random.default_rng(404)
    for _ in range(3):
        budget = float(rng.integers(4, 12)) * 25.0
        _, jroot = _random_domain_instance(rng, budget)
        root = _port_tree(jroot)
        mckp_dp.reset_launches()
        got = mckp.solve_hierarchical(root, budget, solver="pallas", device=cuda)
        assert mckp_dp.launches["maxplus_conv_batched"] > 0
        _assert_solution_equal(
            got, mckp.solve_hierarchical(root, budget, solver="jax", device=cuda)
        )
