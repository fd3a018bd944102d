"""The port's baseline policies and Oracle against the JAX package.

Both packages get the same inputs (the paper suite's surfaces rebuilt from
the same seeds, the same baselines and budgets).  The baselines, the Oracle
and their ``ClusterSim.run`` records are host numpy in both packages, so
every comparison is exact (``==`` on floats, dicts and byte strings).
"""

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import Scenario as JScenario
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import policies as jpolicies
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch.cluster import ClusterSim, Scenario
from repro_torch.cluster.controller import (
    ControllerConfig,
    EcoShiftOnlineController,
    OracleController,
    make_controller,
)
from repro_torch.core import mckp, policies, surfaces, types

# tiny shapes: one intra-op thread keeps this file off the other workers
torch.set_num_threads(1)
CPU = "cpu"
BASELINES = ("uniform", "dps", "mixed_adaptive")
N_NODES, N_ROUNDS, BUDGET = 16, 3, 400.0


def _bits(x: float) -> bytes:
    return np.float64(x).tobytes()


def _assert_alloc_equal(got, want):
    assert dict(got.caps) == dict(want.caps)
    assert _bits(got.spent) == _bits(want.spent)
    # the heuristics predict nothing (NaN): compare the bits
    assert _bits(got.predicted_improvement) == _bits(want.predicted_improvement)


@pytest.fixture(scope="module")
def table2():
    """Paper §6.2: cfd + raytracing at (300, 200) with 200 W reclaimed, the
    shapes of tests/test_policies.py, in both packages."""
    out = []
    for t, s in ((jtypes, jsurfaces), (types, surfaces)):
        grid = t.CapGrid(cpu_min=200, cpu_max=500, gpu_min=100, gpu_max=500, step=50)
        system = t.SystemSpec(name="system2-h100", grid=grid, init_cpu=300, init_gpu=200)
        apps = [t.AppSpec("cfd", "C", "cfd"), t.AppSpec("raytracing", "G", "raytracing")]
        surfs = {"cfd": s.cfd_surface(), "raytracing": s.raytracing_surface()}
        out.append((system, apps, surfs))
    return out, {"cfd": (300.0, 200.0), "raytracing": (300.0, 200.0)}


def _avg_gain(alloc, surfs, baselines):
    return float(
        np.mean(
            [
                float(surfs[name].improvement(baselines[name], c, g))
                for name, (c, g) in alloc.caps.items()
            ]
        )
    )


def _call(pkg_policies, pname, apps, baselines, budget, system, surfs):
    if pname.startswith("oracle"):
        return pkg_policies.oracle(
            apps, baselines, budget, system, surfs,
            exhaustive=pname == "oracle_brute",
        )
    return pkg_policies.POLICIES[pname](apps, baselines, budget, system, surfs)


@pytest.mark.parametrize(
    "pname", BASELINES + ("ecoshift", "oracle_brute", "oracle_sparse")
)
def test_table2_policies_match_reference(table2, pname):
    ((jsys, japps, jsurfs), (tsys, tapps, tsurfs)), baselines = table2
    want = _call(jpolicies, pname, japps, baselines, 200.0, jsys, jsurfs)
    got = _call(policies, pname, tapps, baselines, 200.0, tsys, tsurfs)
    _assert_alloc_equal(got, want)


def test_table2_ordering(table2):
    """EcoShift > MixedAdaptive > DPS (Table 2), on the port's policies;
    the Oracle equals EcoShift here and DPS splits 100 W each 50/50."""
    (_, (tsys, tapps, tsurfs)), baselines = table2
    g = {
        p: _avg_gain(
            policies.POLICIES[p](tapps, baselines, 200.0, tsys, tsurfs),
            tsurfs, baselines,
        )
        for p in ("ecoshift", "dps", "mixed_adaptive", "oracle")
    }
    assert g["ecoshift"] > g["mixed_adaptive"] > g["dps"]
    assert g["ecoshift"] > 0.14 and g["dps"] < 0.13
    assert abs(g["oracle"] - g["ecoshift"]) <= 1e-9
    dps = policies.dps(tapps, baselines, 200.0, tsys, tsurfs)
    assert dps.caps == {"cfd": (350.0, 250.0), "raytracing": (350.0, 250.0)}


@pytest.mark.parametrize("budget", [0.0, 300.0, 1500.0])
@pytest.mark.parametrize("pname", BASELINES + ("ecoshift",))
def test_invariant_suite_matches_reference(pname, budget):
    """tests/test_policies.py's invariant shapes: SYSTEM_1, 12 apps."""
    runs = []
    for t, s, pol in ((jtypes, jsurfaces, jpolicies), (types, surfaces, policies)):
        system = t.SYSTEM_1
        apps, surfs = s.build_paper_suite(system)
        apps = apps[:12]
        surfs = {a.name: surfs[a.name] for a in apps}
        baselines = {a.name: (system.init_cpu, system.init_gpu) for a in apps}
        alloc = pol.POLICIES[pname](apps, baselines, budget, system, surfs)
        t.validate_allocation(alloc, baselines, budget, system.grid)
        runs.append(alloc)
    _assert_alloc_equal(runs[1], runs[0])


def test_dps_and_mixed_adaptive_exact_shares():
    """No clamping: DPS gives B/N split 50/50, MixedAdaptive splits in
    proportion to component demand (tests/test_policies.py's cases)."""
    jsys, tsys = jtypes.SYSTEM_2, types.SYSTEM_2
    apps = [types.AppSpec(f"a{i}", "B", f"a{i}") for i in range(4)]
    base = {a.name: (250.0, 150.0) for a in apps}
    alloc = policies.dps(apps, base, 400.0, tsys, None)
    assert all(alloc.caps[a.name] == (300.0, 200.0) for a in apps)
    _assert_alloc_equal(
        alloc,
        jpolicies.dps(
            [jtypes.AppSpec(a.name, "B", a.name) for a in apps], base, 400.0, jsys, None
        ),
    )
    allocs = []
    for t, s, pol, sys_ in ((jtypes, jsurfaces, jpolicies, jsys),
                            (types, surfaces, policies, tsys)):
        def surf(nat_c, nat_g, s=s):
            return s.AnalyticSurface(
                host_work=1, dev_work=1, phi_h=s.SpeedCurve(100, 100),
                phi_d=s.SpeedCurve(100, 100), natural_cpu=nat_c, natural_gpu=nat_g,
            )

        two = [t.AppSpec("hi", "B", "hi"), t.AppSpec("lo", "B", "lo")]
        b2 = {"hi": (250.0, 150.0), "lo": (250.0, 150.0)}
        surfs = {"hi": surf(400.0, 150.0), "lo": surf(250.0, 200.0)}
        allocs.append(pol.mixed_adaptive(two, b2, 100.0, sys_, surfs))
    assert allocs[1].caps == {"hi": (325.0, 150.0), "lo": (250.0, 175.0)}
    _assert_alloc_equal(allocs[1], allocs[0])


@pytest.mark.parametrize("budget", [200.0, 300.0])
def test_oracle_modes_match_reference_and_each_other(budget):
    """Ten C/G apps (tests/test_policies.py's dominance case, at budgets
    the exponential brute force takes in about a second): the brute force
    and the sparse DP agree with each other and with the reference, and
    EcoShift on true surfaces dominates the heuristics."""
    allocs = {}
    for pkg, t, s, pol in (("jax", jtypes, jsurfaces, jpolicies),
                           ("torch", types, surfaces, policies)):
        system = t.SYSTEM_2
        apps, surfs = s.build_paper_suite(system)
        apps = [a for a in apps if a.sclass in "CG"][:10]
        surfs = {a.name: surfs[a.name] for a in apps}
        base = {a.name: (250.0, 150.0) for a in apps}
        for mode in (True, False):
            allocs[pkg, mode] = pol.oracle(
                apps, base, budget, system, surfs, exhaustive=mode
            )
        if pkg == "torch":
            gains = {
                p: _avg_gain(pol.POLICIES[p](apps, base, budget, system, surfs), surfs, base)
                for p in ("ecoshift", "dps", "mixed_adaptive")
            }
    for mode in (True, False):
        _assert_alloc_equal(allocs["torch", mode], allocs["jax", mode])
    _assert_alloc_equal(allocs["torch", True], allocs["torch", False])
    assert gains["ecoshift"] >= max(gains["dps"], gains["mixed_adaptive"]) - 1e-9


# ---------------------------------------------------------------------------
# ClusterSim.run records under each controller
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_2),
        surfaces.build_paper_suite(types.SYSTEM_2),
    )


def _scenario(scen_cls, recv):
    return (
        scen_cls.constant(N_ROUNDS, BUDGET)
        .with_failure(1, recv[0].node_id)
        .with_straggler(2, recv[1].node_id, 1.8)
    )


def assert_records_equal(got, want, n_rounds=N_ROUNDS):
    assert got.policy == want.policy
    assert len(got.records) == len(want.records) == n_rounds
    for g, w in zip(got.records, want.records):
        _assert_alloc_equal(g.result.allocation, w.result.allocation)
        assert g.result.improvements == w.result.improvements
        assert (g.pool, g.n_alive, g.result.budget) == (w.pool, w.n_alive, w.result.budget)
        assert g.result.allocation.spent <= g.result.budget + 1e-9
        gt, wt = g.telemetry, w.telemetry
        assert gt.instances == wt.instances
        for col in ("allocated_caps", "t_baseline", "t_allocated", "improvement"):
            assert getattr(gt, col).tobytes() == getattr(wt, col).tobytes()


@pytest.mark.parametrize("n_nodes", [N_NODES, 8])
@pytest.mark.parametrize("policy", BASELINES + ("oracle",))
def test_sim_records_match_reference(suites, policy, n_nodes):
    """A seeded failure + straggler scenario; at 8 nodes the Oracle has at
    most 10 receivers and runs its brute force, at 16 its sparse DP."""
    (japps, jsurfs), (tapps, tsurfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_2, japps, jsurfs, n_nodes=n_nodes, seed=0)
    _, jrecv, _ = jsim.partition()
    want = jsim.run(_scenario(JScenario, jrecv), j_make_controller(policy, jtypes.SYSTEM_2))
    tsim = ClusterSim.build(types.SYSTEM_2, tapps, tsurfs, n_nodes=n_nodes, seed=0, device=CPU)
    _, trecv, _ = tsim.partition()
    got = tsim.run(_scenario(Scenario, trecv), make_controller(policy, types.SYSTEM_2))
    assert_records_equal(got, want)
    if policy == "oracle":
        assert (len(jrecv) <= 10) == (n_nodes == 8)


def test_sim_run_takes_policy_names(suites):
    _, (tapps, tsurfs) = suites
    sim = ClusterSim.build(types.SYSTEM_2, tapps, tsurfs, n_nodes=8, seed=0, device=CPU)
    for name in BASELINES + ("oracle",):
        assert sim.run(Scenario.constant(1, BUDGET), name).policy == name


def test_make_controller_builds_every_policy_of_the_comparison():
    from repro_torch.cluster import OnlinePredictor
    from repro_torch.core.ncf import NCFConfig, NCFPredictor

    sysm = types.SYSTEM_2
    ncf = NCFPredictor(
        system=sysm, cfg=NCFConfig(embed_dim=4, mlp_hidden=(8,)),
        params={}, app_index={}, cfg_feats=np.zeros((221, 2), np.float32), device=CPU,
    )
    pred = OnlinePredictor(ncf)
    for name in BASELINES:
        assert make_controller(name, sysm).policy == name
    assert make_controller("ecoshift", sysm, solver="pallas", device=CPU).solver == "pallas"
    orc = make_controller("oracle", sysm, exhaustive=False)
    assert isinstance(orc, OracleController) and orc.sees_truth and not orc.exhaustive
    online = make_controller("ecoshift_online", sysm, predictor=pred, solver="pallas",
                             device=CPU)
    assert isinstance(online, EcoShiftOnlineController)
    assert online.serves_own_surfaces and online.predictor is pred
    cfg = ControllerConfig(predictor=pred, solver="jax", device=CPU)
    assert make_controller("ecoshift_online", sysm, config=cfg).solver == "jax"
    with pytest.raises(ValueError, match="needs a predictor"):
        make_controller("ecoshift_online", sysm, device=CPU)


def test_oracle_controller_grouped_matches_ungrouped(suites):
    """The Oracle's grouped round (behaviour classes, sparse grouped DP)
    equals its per-instance round and the pure policy on the same
    receivers."""
    _, (tapps, tsurfs) = suites
    # four apps over 24 nodes: receivers share behaviour classes
    sim = ClusterSim.build(types.SYSTEM_2, tapps[:4], tsurfs, n_nodes=24, seed=1,
                           device=CPU)
    _, recv, pool = sim.partition()
    apps = [n.app for n in recv]
    base = {n.app.name: n.caps for n in recv}
    true = {n.app.name: sim._surface(n) for n in recv}
    ctrl = OracleController(types.SYSTEM_2)
    flat = ctrl.allocate(apps, base, pool, true)
    batch = sim._receiver_batch(sim.partition_rows()[1], None, True)
    _assert_alloc_equal(ctrl.allocate_grouped(batch, pool), flat)
    _assert_alloc_equal(policies.oracle(apps, base, pool, types.SYSTEM_2, true,
                                        exhaustive=False), flat)
    assert ctrl.cached_tables > 0
    groups = ctrl._grouped_options_for(batch)
    assert sum(len(g.members) for g in groups) == len(recv) > len(groups)
    assert mckp.solve_sparse(mckp.expand_groups(groups), pool).spent == flat.spent
