"""The port's budget providers and receding-horizon (MPC) planning against
the JAX package, bit for bit.

* providers, composition, step overrides, the override book's
  ``provider_for``, the shipped fixtures (byte-equal copies) and
  ``solar_budget``; the scenario builders (``with_budget`` deprecation,
  forecasts, ``carbon_aware``, ``price_capped``);
* ``frontier_records`` and ``plan_horizon`` on tests/test_budget_horizon.py's
  ``TestPlanHorizon`` cases, and ``grouped_frontier`` /
  ``hierarchical_frontier`` arrays on tests/test_hier_alloc.py's random
  groups and domain trees;
* ``ClusterSim.run`` records with H = 1 and eco = 1 (passthrough, equal
  to the myopic controller), and with the planner active — flat and
  hierarchical, CO2-weighted and price-weighted — each round's planned
  budget included; the port's fused MPC rounds against its host rounds
  and the reference's host rounds through arrivals, failures and
  stragglers;
* ``ControllerConfig``'s aliases (tests/test_budget.py's cases).

numpy seeds throughout; tolerance zero.
"""

import filecmp
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import PowerTopology as JTopology
from repro.cluster import budget as jbm
from repro.cluster import scenario as jsc
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import mckp as jmckp
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch import interop
from repro_torch.cluster import ClusterSim
from repro_torch.cluster import budget as bm
from repro_torch.cluster import scenario as sc
from repro_torch.cluster.controller import (
    ControllerConfig,
    EcoShiftController,
    EcoShiftHierController,
    EcoShiftOnlineController,
    OracleController,
    make_controller,
)
from repro_torch.core import mckp, surfaces, types
from test_hier_alloc import _random_domain_instance, _random_groups

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


def _port_groups(jgroups):
    return interop.grouped_options_from_arrays(
        [(g.table.name, g.table.costs, g.table.values, g.table.caps, g.members)
         for g in jgroups]
    )


def _port_tree(jdom):
    if jdom.children:
        return mckp.DomainGroups(
            name=jdom.name, cap=jdom.cap,
            children=tuple(_port_tree(c) for c in jdom.children),
        )
    return mckp.DomainGroups(
        name=jdom.name, cap=jdom.cap, groups=tuple(_port_groups(jdom.groups))
    )


def _bytes(*arrays):
    return tuple(np.asarray(a).tobytes() for a in arrays)


# ---------------------------------------------------------------------------
# Providers, fixtures, scenarios
# ---------------------------------------------------------------------------


def _provider_pairs():
    """(port, reference) providers built alike."""
    out = []
    for m in (bm, jbm):
        out.append([
            m.ConstantProvider(150.0),
            m.TraceReplayProvider([10.0, 20.0, 30.0]),
            m.TraceReplayProvider(lambda r: 100.0 + r),
            m.ScaledProvider([100.0, 200.0], 0.5),
            m.ScaledProvider(None, 0.5),
            m.MinProvider([100.0, 300.0], m.ConstantProvider(200.0)),
            m.MinProvider(m.ConstantProvider(None), 50.0),
            m.MinProvider(None, None),
            m.ConstantProvider(100.0).scaled(0.3).min_with(40.0),
            m.ConstantProvider(100.0).scaled(0.3),
            m.StepOverrideProvider(100.0, [(3, 60.0)]),
            m.StepOverrideProvider(100.0, {4: 50.0, 2: np.float32(80.1)}),
            m.solar_budget(1000.0, floor_watts=200.0, n_rounds=96),
            m.solar_budget(2.5 * 128, floor_watts=0.5 * 128, n_rounds=24),
            m.fixture_provider("co2_day", 30),
        ])
    return list(zip(*out))


@pytest.mark.parametrize("i", range(15))
def test_providers_match_reference(i):
    port, ref = _provider_pairs()[i]
    assert isinstance(port, bm.BudgetProvider)
    assert [port.budget_at(r) for r in range(100)] == [ref.budget_at(r) for r in range(100)]
    assert port.forecast(7, 12) == ref.forecast(7, 12)


def test_provider_edges():
    with pytest.raises(ValueError):
        bm.MinProvider()
    with pytest.raises(TypeError):
        bm.TraceReplayProvider(object())
    book, jbook = bm.OverrideBook(), jbm.OverrideBook()
    for b in (book, jbook):
        b.set(3, 4, 250.0)
        b.set(3, 7, np.float32(120.3))
    for dom, base in ((3, 1000.0), (7, 111.0)):
        p, q = book.provider_for(dom, base=base), jbook.provider_for(dom, base=base)
        assert [p.budget_at(r) for r in range(10)] == [q.budget_at(r) for r in range(10)]


@pytest.mark.parametrize("name", ["co2_day", "price_day", "solar_day"])
def test_fixtures_are_byte_copies(name):
    port = REPO / "src" / "repro_torch" / "cluster" / "fixtures" / f"{name}.json"
    ref = REPO / "src" / "repro" / "cluster" / "fixtures" / f"{name}.json"
    assert filecmp.cmp(port, ref, shallow=False)
    assert Path(bm._FIXTURE_DIR).resolve() == port.parent.resolve()
    assert bm.load_fixture(name) == jbm.load_fixture(name)
    for n in (None, 12, 24, 96, 200):
        assert bm.fixture_trace(name, n) == jbm.fixture_trace(name, n)


def test_scenario_builders_match_reference():
    with pytest.warns(DeprecationWarning, match="with_budget_provider"):
        old = sc.Scenario(n_rounds=6).with_budget([10.0, 20.0, 30.0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        new = sc.Scenario(n_rounds=6).with_budget_provider([10.0, 20.0, 30.0])
    assert [old.budget_at(r) for r in range(6)] == [new.budget_at(r) for r in range(6)]
    assert sc.Scenario(n_rounds=4).budget_forecast(0, 3) == (None, None, None)
    pairs = [
        (sc.Scenario.carbon_aware(24, 3000.0), jsc.Scenario.carbon_aware(24, 3000.0)),
        (sc.Scenario.carbon_aware(96, bm.ConstantProvider(512.0)),
         jsc.Scenario.carbon_aware(96, jbm.ConstantProvider(512.0))),
        (sc.Scenario.price_capped(8, 900.0, [30.0, 60.0, 45.0, 120.0], 27000.0),
         jsc.Scenario.price_capped(8, 900.0, [30.0, 60.0, 45.0, 120.0], 27000.0)),
        (sc.Scenario(10).with_carbon([1.0, 3.0]).with_power_price(bm.ConstantProvider(7.0)),
         jsc.Scenario(10).with_carbon([1.0, 3.0]).with_power_price(jbm.ConstantProvider(7.0))),
    ]
    for p, q in pairs:
        for r in (0, 3, 7, 20):
            h = 12
            assert p.budget_forecast(r, h) == q.budget_forecast(r, h)
            assert p.carbon_forecast(r, h) == q.carbon_forecast(r, h)
            assert p.price_forecast(r, h) == q.price_forecast(r, h)
            assert (p.budget_at(r), p.carbon_at(r), p.price_at(r)) == (
                q.budget_at(r), q.carbon_at(r), q.price_at(r))


# ---------------------------------------------------------------------------
# plan_horizon and the frontiers
# ---------------------------------------------------------------------------


KEYS = np.arange(11, dtype=np.float64)
VALS = np.sqrt(np.arange(11, dtype=np.float64))
LONG_KEYS = np.linspace(0, 1000, 5000)

#: tests/test_budget_horizon.py's TestPlanHorizon calls, plus weighted and
#: lattice variants
PLAN_CASES = [
    (KEYS, VALS, [10.0], None, {}),
    (KEYS, VALS, [10.0, 10.0], None, {"eco_factor": 1.0}),
    (np.empty(0), np.empty(0), [10.0, 10.0], None, {"eco_factor": 0.5}),
    (KEYS, VALS, [10.0, 10.0, 10.0], None, {"eco_factor": 0.5}),
    (KEYS, VALS, [10.0, 10.0], [10.0, 1.0], {"eco_factor": 0.5}),
    (KEYS, VALS, [10.0, 3.0, 5.0], [1.0, 1.0, 1.0], {"eco_factor": 0.6}),
    (KEYS, VALS, [3.0, 7.0, 5.0], [1.0, 1.0, 1.0], {"eco_factor": 0.6}),
    (KEYS, VALS, [10.0, 10.0], None, {"eco_factor": 0.999999}),
    (LONG_KEYS, np.sqrt(LONG_KEYS), [1000.0, 1000.0], [5.0, 1.0],
     {"eco_factor": 0.5, "levels": 16}),
    (LONG_KEYS, np.sqrt(LONG_KEYS), [900.0, 1000.0, 400.0, 1000.0], [3.0, 1.0, 2.0, 0.0],
     {"eco_factor": 0.7, "levels": 64, "grid": 512}),
    (KEYS, VALS, [10.0, 10.0, 10.0], [0.0, 0.0, 0.0], {"eco_factor": 0.5}),
]


@pytest.mark.parametrize("i", range(len(PLAN_CASES)))
def test_plan_horizon_matches_reference(i):
    keys, vals, caps, weights, kw = PLAN_CASES[i]
    got = mckp.plan_horizon(keys, vals, caps, weights, **kw)
    want = jmckp.plan_horizon(keys, vals, caps, weights, **kw)
    assert got == want
    if got is not None:
        assert all(isinstance(s, float) for s in got)


def test_frontier_records_match_reference():
    rng = np.random.default_rng(5)
    cases = [(np.array([0.0, 1.0, 2.0, 3.0, 4.0]), np.array([0.0, 2.0, 2.0, 1.5, 3.0]))]
    for _ in range(10):
        k = np.sort(rng.uniform(0, 100, 50))
        cases.append((k, rng.normal(size=50).cumsum()))
    for k, v in cases:
        assert _bytes(*mckp.frontier_records(k, v)) == _bytes(*jmckp.frontier_records(k, v))


@pytest.mark.parametrize("seed", range(6))
def test_grouped_frontier_matches_reference(seed):
    rng = np.random.default_rng(seed)
    budget = float(rng.integers(3, 40)) * 25.0
    jg = _random_groups(rng, budget)
    for cutoff in (budget, mckp._curve_cutoff(budget)):
        got = mckp.grouped_frontier(_port_groups(jg), cutoff)
        want = jmckp.grouped_frontier(jg, cutoff)
        assert _bytes(*got) == _bytes(*want)
        warm = mckp.grouped_frontier(
            _port_groups(jg), cutoff, curve_cache={}, plan_cache={}, chain_cache={}
        )
        assert _bytes(*warm) == _bytes(*want)


@pytest.mark.parametrize("seed", range(6))
def test_hierarchical_frontier_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    budget = float(rng.integers(4, 30)) * 25.0
    _, jroot = _random_domain_instance(rng, budget)
    root = _port_tree(jroot)
    state = mckp.HierState()
    got = mckp.hierarchical_frontier(root, budget, state=state)
    want = jmckp.hierarchical_frontier(jroot, budget)
    assert _bytes(*got) == _bytes(*want)
    # warm: the same state answers again, unchanged
    assert _bytes(*mckp.hierarchical_frontier(root, budget, state=state)) == _bytes(*want)


# ---------------------------------------------------------------------------
# ClusterSim.run under planning
# ---------------------------------------------------------------------------


def _run_pair(suites, pscen, jscen, policy="ecoshift", n_nodes=18, n_apps=6,
              port_kw=None, **kw):
    (japps, jsurfs), (apps, surfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_1, japps[:n_apps], jsurfs, n_nodes=n_nodes, seed=0)
    sim = ClusterSim.build(types.SYSTEM_1, apps[:n_apps], surfs, n_nodes=n_nodes, seed=0,
                           device=CPU)
    jctrl = j_make_controller(policy, jtypes.SYSTEM_1, **kw)
    ctrl = make_controller(policy, types.SYSTEM_1, device=CPU, **kw, **(port_kw or {}))
    trace = []
    inner = ctrl._plan_budget

    def plan_budget(budget, frontier_fn):
        out = inner(budget, frontier_fn)
        trace.append((ctrl.last_planned_budget, ctrl.last_plan))
        return out

    ctrl._plan_budget = plan_budget
    jtrace = []
    jinner = jctrl._plan_budget

    def jplan_budget(budget, frontier_fn):
        out = jinner(budget, frontier_fn)
        jtrace.append((jctrl.last_planned_budget, jctrl.last_plan))
        return out

    jctrl._plan_budget = jplan_budget
    return sim.run(pscen, ctrl), jsim.run(jscen, jctrl), ctrl, trace, jtrace


def _assert_records_equal(got, want):
    assert len(got.records) == len(want.records)
    for rg, rw in zip(got.records, want.records):
        ag, aw = rg.result.allocation, rw.result.allocation
        assert dict(ag.caps) == dict(aw.caps), rg.round
        assert ag.spent == aw.spent
        assert ag.predicted_improvement == aw.predicted_improvement
        assert rg.result.improvements == rw.result.improvements
        assert rg.result.budget == rw.result.budget
        assert rg.carbon_intensity == rw.carbon_intensity
        assert rg.power_price == rw.power_price
        assert rg.domain_draw == rw.domain_draw


BUDGET8 = [3000.0, 2800.0, 3100.0, 2900.0, 3000.0, 2700.0, 3050.0, 2950.0]


def _scen(mod, topo=None, **kw):
    s = mod.Scenario(**kw)
    return s if topo is None else s.with_topology(topo)


@pytest.mark.parametrize("case", ["h1", "eco1", "h1_hier", "constant"])
def test_passthrough_matches_myopic_and_reference(suites, case):
    """H = 1 or eco = 1: the planner never engages and the records equal
    the plain controller's and the reference's."""
    jtopo = JTopology.uniform_racks(18, 3, rack_cap=4000.0) if case == "h1_hier" else None
    topo = None if jtopo is None else interop.topology_from_parts(jtopo)
    policy = "ecoshift_hier" if jtopo is not None else "ecoshift"
    if case == "eco1":
        kws = dict(n_rounds=8, budget=BUDGET8)
        ps = _scen(sc, **kws).with_carbon(bm.fixture_trace("co2_day", 8))
        js = _scen(jsc, **kws).with_carbon(jbm.fixture_trace("co2_day", 8))
        ctrl_kw = dict(horizon=6, eco_factor=1.0)
    elif case == "constant":
        ps = sc.Scenario(n_rounds=6, budget=bm.ConstantProvider(3000.0))
        js = jsc.Scenario(n_rounds=6, budget=3000.0)
        ctrl_kw = dict(horizon=6, eco_factor=1.0)
    else:
        ps = _scen(sc, topo, n_rounds=8, budget=BUDGET8)
        js = _scen(jsc, jtopo, n_rounds=8, budget=BUDGET8)
        ctrl_kw = dict(horizon=1, eco_factor=0.6)
    got, want, ctrl, trace, _ = _run_pair(suites, ps, js, policy, **ctrl_kw)
    plain, _, _, _, _ = _run_pair(suites, ps, js, policy)
    _assert_records_equal(got, want)
    _assert_records_equal(got, plain)
    assert ctrl.last_planned_budget is None
    assert all(t == (None, None) for t in trace)


def _co2(mod, n_rounds=16, budget=3000.0):
    return mod.Scenario(n_rounds=n_rounds, budget=budget,
                        carbon=mod.budget_mod.fixture_trace("co2_day", n_rounds))


@pytest.mark.parametrize("case", ["co2", "price", "hier_co2", "flat_events", "dense_myopic"])
def test_active_mpc_matches_reference(suites, case):
    """The planner engaged: per-round planned budgets and plans, and the
    records, equal the reference's; every round spends within its budget."""
    policy, kw, port_kw = "ecoshift", dict(horizon=8, eco_factor=0.7), None
    if case == "co2":
        ps, js = _co2(sc), _co2(jsc)
    elif case == "price":
        ps = sc.Scenario(n_rounds=12, budget=3000.0,
                         power_price=bm.fixture_trace("price_day", 12))
        js = jsc.Scenario(n_rounds=12, budget=3000.0,
                          power_price=jbm.fixture_trace("price_day", 12))
        kw = dict(horizon=6, eco_factor=0.7)
    elif case == "hier_co2":
        jtopo = JTopology.uniform_racks(18, 3, rack_cap=4000.0)
        ps = _co2(sc).with_topology(interop.topology_from_parts(jtopo))
        js = _co2(jsc).with_topology(jtopo)
        policy = "ecoshift_hier"
    elif case == "flat_events":
        ps = _co2(sc, 12).with_failure(3, 1).with_straggler(6, 4, 1.5)
        js = _co2(jsc, 12).with_failure(3, 1).with_straggler(6, 4, 1.5)
        kw = dict(horizon=6, eco_factor=0.7)
    else:  # the dense solver takes no plan: the myopic path, bitwise
        ps, js = _co2(sc, 4), _co2(jsc, 4)
        kw = dict(horizon=3, eco_factor=0.7, solver="jax")
    got, want, ctrl, trace, jtrace = _run_pair(suites, ps, js, policy, port_kw=port_kw, **kw)
    _assert_records_equal(got, want)
    assert trace == jtrace
    for rec in got.records:
        assert rec.result.allocation.spent <= rec.result.budget + 1e-6
        for name, draw in (rec.domain_draw or {}).items():
            assert draw <= rec.domain_caps[name] + 1e-6
    if case != "dense_myopic":
        assert any(t[0] is not None for t in trace), "the planner never restricted a round"


@pytest.mark.parametrize("policy", ["ecoshift", "ecoshift_hier"])
def test_fused_mpc_matches_host_through_events(suites, policy):
    """tests/test_budget_horizon.py's structure-change scenario (a failure,
    an arrival, a straggler mid-horizon): the port's fused MPC rounds equal
    its host MPC rounds and the reference's host rounds, planned budgets
    included, and stay fused."""
    (japps, _), (apps, _) = suites
    n = 18
    jtopo = JTopology.uniform_racks(n, 3, rack_cap=4000.0)
    topo = interop.topology_from_parts(jtopo)
    pscen, jscen = [
        mod.Scenario(n_rounds=14, budget=3200.0,
                     carbon=mod.budget_mod.fixture_trace("co2_day", 14))
        for mod in (sc, jsc)
    ]
    if policy == "ecoshift_hier":
        pscen, jscen = pscen.with_topology(topo), jscen.with_topology(jtopo)
        arrive = {"domain": "rack1"}
    else:
        arrive = {}
    pscen = (pscen.with_failure(4, 2, 7).with_arrival(8, apps[0], **arrive)
             .with_straggler(10, 11, 1.6))
    jscen = (jscen.with_failure(4, 2, 7).with_arrival(8, japps[0], **arrive)
             .with_straggler(10, 11, 1.6))
    kw = dict(horizon=8, eco_factor=0.7)
    host, want, _, htrace, jtrace = _run_pair(suites, pscen, jscen, policy, **kw)
    fused, _, ctrl, ftrace, _ = _run_pair(suites, pscen, jscen, policy,
                                          port_kw={"fused": True}, **kw)
    _assert_records_equal(host, want)
    _assert_records_equal(fused, want)
    assert ftrace == htrace == jtrace
    st = ctrl.fused_stats()
    assert st.fallbacks == 0 and st.rounds > 0


# ---------------------------------------------------------------------------
# ControllerConfig aliases (tests/test_budget.py's cases)
# ---------------------------------------------------------------------------


def test_config_aliases(suites):
    system = types.SYSTEM_1
    a = EcoShiftController(system, solver="dense", unit=2.0, fused=True, device=CPU)
    b = EcoShiftController(
        system, config=ControllerConfig(solver="dense", unit=2.0, fused=True, device=CPU)
    )
    assert (a.solver, a.unit, a.fused) == (b.solver, b.unit, b.fused)
    assert a.config == b.config
    cfg = ControllerConfig(horizon=8, eco_factor=0.7, solver="dense", device=CPU)
    c = EcoShiftController(system, config=cfg, horizon=4)
    assert c.horizon == 4 and c.eco_factor == 0.7 and c.solver == "dense"
    d = EcoShiftController(system, device=CPU)
    assert (d.solver, d.unit, d.grouped, d.incremental, d.fused) == (
        "sparse", 1.0, True, True, False)
    assert (d.horizon, d.eco_factor, d.plan_levels, d.plan_grid) == (1, 1.0, 64, 2048)
    assert make_controller("ecoshift", system, device=CPU,
                           config=ControllerConfig(horizon=6, eco_factor=0.8)).horizon == 6


def test_hier_config_carries_topology_and_bounds():
    """tests/test_budget.py:356-362: ``ControllerConfig.topology`` reaches
    the hier controller; the cache bounds resize the caches in place."""
    topo = interop.topology_from_parts(JTopology.single_root(8, cap=1e6))
    c = EcoShiftHierController(
        types.SYSTEM_1, device=CPU,
        config=ControllerConfig(topology=topo, max_frontiers=3, max_plans=2),
    )
    assert c.topology is topo
    assert c._frontiers.maxsize == 3 and c._plan_cache.maxsize == 2
    assert c._hier_state.plan_cache is c._plan_cache
    k = EcoShiftHierController(types.SYSTEM_1, topology=topo, device=CPU)
    assert k.topology is topo
    with pytest.raises(ValueError, match="predictor"):
        EcoShiftOnlineController(types.SYSTEM_1, device=CPU)
    o = OracleController(types.SYSTEM_1, config=ControllerConfig(exhaustive=True,
                                                                 max_picks=5))
    assert o.exhaustive is True and o._pick_cache.maxsize == 5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["ecoshift", "ecoshift_hier"])
def test_fused_mpc_on_card_matches_host(cuda, suites, policy):
    """Fused MPC rounds on the card (kernel 2.1) against the port's host
    MPC rounds, records and planned budgets."""
    _, (apps, surfs) = suites
    jtopo = JTopology.uniform_racks(18, 3, rack_cap=4000.0)
    scen = _co2(sc)
    if policy == "ecoshift_hier":
        scen = scen.with_topology(interop.topology_from_parts(jtopo))
    runs = []
    for kw in ({"fused": True}, {}):
        sim = ClusterSim.build(types.SYSTEM_1, apps[:6], surfs, n_nodes=18, seed=0,
                               device=cuda)
        ctrl = make_controller(policy, types.SYSTEM_1, device=cuda, horizon=8,
                               eco_factor=0.7, **kw)
        runs.append((sim.run(scen, ctrl), ctrl))
    (fused, ctrl), (host, _) = runs
    _assert_records_equal(fused, host)
    assert ctrl.fused_stats().fallbacks == 0 and ctrl.fused_stats().rounds > 0
