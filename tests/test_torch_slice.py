"""The port's EcoShift control round against the JAX package, bit for bit.

Both packages get the same inputs (numpy arrays and seeds); the port runs
on ``device="cpu"``, where its kernel wrappers take the plain PyTorch
version, and the JAX package runs its Pallas kernels in interpret mode.
Every comparison is exact: the dense DP computes in float32 in both
packages, and the engine's measurement is the same numpy stream.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import Scenario as JScenario
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import curves as jcurves
from repro.core import emulator as jemulator
from repro.core import mckp as jmckp
from repro.core import policies as jpolicies
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch.cluster import ClusterSim, Scenario, controller as tcontroller
from repro_torch.cluster.controller import make_controller
from repro_torch.core import curves, emulator, mckp, policies, surfaces, types
from repro_torch.device import resolve_device
from repro_torch.interop import COLUMNS, node_table_from_columns

ROOT = Path(__file__).resolve().parents[1]
# the shapes here are tiny: one intra-op thread keeps this file from
# crowding the other test workers' cores
torch.set_num_threads(1)
CPU = "cpu"


# ---------------------------------------------------------------------------
# Numpy foundations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system_name", ["system1-a100", "system2-h100"])
def test_option_tables_and_dense_curves_match(system_name):
    jsys, tsys = jtypes.SYSTEMS[system_name], types.SYSTEMS[system_name]
    japps, jsurfs = jsurfaces.build_paper_suite(jsys)
    tapps, tsurfs = surfaces.build_paper_suite(tsys)
    assert [a.name for a in japps] == [a.name for a in tapps]
    base = (jsys.init_cpu, jsys.init_gpu)
    jtabs, ttabs = [], []
    for a in japps:
        jt = jcurves.build_options(a.name, jsurfs[a.name], base, jsys.grid, 900.0)
        tt = curves.build_options(a.name, tsurfs[a.name], base, tsys.grid, 900.0)
        assert jmckp.table_digest(jt) == mckp.table_digest(tt)
        jf, jch = jcurves.dense_curve(jt, 900.0)
        tf, tch = curves.dense_curve(tt, 900.0)
        assert jf.tobytes() == tf.tobytes() and jch.tobytes() == tch.tobytes()
        jtabs.append(jt)
        ttabs.append(tt)
    jm = jcurves.dense_curves_matrix(jtabs, 700.0)
    tm = curves.dense_curves_matrix(ttabs, 700.0)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(jm, tm))


# ---------------------------------------------------------------------------
# Dense solvers on the shapes of tests/test_grouped_alloc.py
# ---------------------------------------------------------------------------


def _random_groups(rng: np.random.Generator, budget: float):
    """The same random behaviour classes as (reference groups, port
    groups): interleaved member names and an occasional byte-identical
    duplicate table (the straggler split)."""
    n_groups = int(rng.integers(1, 6))
    sizes = [int(rng.integers(1, 8)) for _ in range(n_groups)]
    slots: list[int] = []
    for g, m in enumerate(sizes):
        slots += [g] * m
    rng.shuffle(slots)
    members: dict[int, list[str]] = {g: [] for g in range(n_groups)}
    for i, g in enumerate(slots):
        members[g].append(f"x{i:03d}")
    specs = []
    for g in range(n_groups):
        k = int(rng.integers(1, 7))
        costs = np.unique(
            rng.integers(1, max(2, int(budget / 25)), size=k)
        ).astype(float) * 25.0
        values = np.sort(rng.uniform(0.01, 0.5, size=len(costs)))
        caps = np.stack([100.0 + costs, np.full_like(costs, 100.0)], axis=-1)
        specs.append(
            (
                f"class{g}",
                np.concatenate([[0.0], costs]),
                np.concatenate([[0.0], values]),
                np.concatenate([[[100.0, 100.0]], caps], axis=0),
                tuple(sorted(members[g])),
            )
        )
    if n_groups >= 2 and rng.random() < 0.4:
        _, c0, v0, k0, _ = specs[0]
        specs[1] = ("dup", c0.copy(), v0.copy(), k0.copy(), specs[1][4])

    def build(curves_mod, mckp_mod):
        return [
            mckp_mod.GroupedOptions(
                table=curves_mod.OptionTable(
                    name=name, costs=c.copy(), values=v.copy(), caps=k.copy()
                ),
                members=m,
            )
            for name, c, v, k, m in specs
        ]

    return build(jcurves, jmckp), build(curves, mckp)


def _assert_solution_equal(got, want):
    assert got.picks == want.picks
    assert got.total_value == want.total_value
    assert got.spent == want.spent


@pytest.mark.parametrize("seed", range(4))
def test_numpy_dense_solvers_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        budget = float(rng.integers(3, 25)) * 25.0
        jg, tg = _random_groups(rng, budget)
        _assert_solution_equal(
            mckp.solve_dense(mckp.expand_groups(tg), budget),
            jmckp.solve_dense(jmckp.expand_groups(jg), budget),
        )
        _assert_solution_equal(
            mckp.solve_dense_grouped(tg, budget),
            jmckp.solve_dense_grouped(jg, budget),
        )


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("seed", range(3))
def test_device_dense_solvers_match(backend, seed):
    rng = np.random.default_rng(100 + seed)
    budget = float(rng.integers(3, 20)) * 25.0
    jg, tg = _random_groups(rng, budget)
    _assert_solution_equal(
        mckp.solve_dense_jax(
            mckp.expand_groups(tg), budget, backend=backend, device=CPU
        ),
        jmckp.solve_dense_jax(jmckp.expand_groups(jg), budget, backend=backend),
    )
    _assert_solution_equal(
        mckp.solve_dense_jax_grouped(tg, budget, backend=backend, device=CPU),
        jmckp.solve_dense_jax_grouped(jg, budget, backend=backend),
    )
    _assert_solution_equal(
        mckp.solve_grouped(tg, budget, solver=backend, device=CPU),
        jmckp.solve_grouped(jg, budget, solver=backend),
    )
    budgets = [budget, budget / 2 + 12.5, 2 * budget]
    got = mckp.solve_dense_jax_batch(
        [mckp.expand_groups(tg)] * 3, budgets, backend=backend, device=CPU
    )
    want = jmckp.solve_dense_jax_batch(
        [jmckp.expand_groups(jg)] * 3, budgets, backend=backend
    )
    for g, w in zip(got, want):
        _assert_solution_equal(g, w)


# ---------------------------------------------------------------------------
# The whole slice: SYSTEM_2, 16 nodes, 3 rounds, 400 W, failure + straggler
# ---------------------------------------------------------------------------

N_NODES, N_ROUNDS, BUDGET = 16, 3, 400.0


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


def _reference_run(suites, solver, grouped):
    (apps, surfs), _ = suites
    sim = JSim.build(jtypes.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0)
    _, recv, _ = sim.partition()
    ctrl = j_make_controller(
        "ecoshift", jtypes.SYSTEM_2, solver=solver, grouped=grouped
    )
    return sim, sim.run(_scenario(JScenario, recv), ctrl)


def _port_run(sim, solver, grouped, device=CPU):
    _, recv, _ = sim.partition()
    ctrl = make_controller(
        "ecoshift", types.SYSTEM_2, solver=solver, grouped=grouped, device=device
    )
    return sim.run(_scenario(Scenario, recv), ctrl)


def _assert_records_equal(got, want):
    assert got.policy == want.policy
    assert len(got.records) == len(want.records) == N_ROUNDS
    for g, w in zip(got.records, want.records):
        ga, wa = g.result.allocation, w.result.allocation
        assert dict(ga.caps) == dict(wa.caps)
        assert ga.spent == wa.spent
        # total_value / n receivers: equal totals over equal receiver sets
        assert ga.predicted_improvement == wa.predicted_improvement
        assert g.result.improvements == w.result.improvements
        assert (g.pool, g.n_alive, g.result.budget) == (w.pool, w.n_alive, w.result.budget)
        assert ga.spent <= g.result.budget + 1e-9
        gt, wt = g.telemetry, w.telemetry
        assert gt.instances == wt.instances
        for col in ("allocated_caps", "t_baseline", "t_allocated", "improvement"):
            assert getattr(gt, col).tobytes() == getattr(wt, col).tobytes()


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("solver", ["pallas", "jax", "dense"])
def test_slice_matches_reference(suites, solver, grouped):
    _, want = _reference_run(suites, solver, grouped)
    _, (apps, surfs) = suites
    sim = ClusterSim.build(
        types.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0, device=CPU
    )
    _assert_records_equal(_port_run(sim, solver, grouped), want)


def test_slice_with_arrival_and_phase_change_matches_reference(suites):
    """Arrivals (a known app and a new one with its own surface) and a
    phase change, beside the failure and the straggler."""
    (japps, jsurfs), (tapps, tsurfs) = suites
    new_j = jsurfaces.cfd_surface()
    new_t = surfaces.cfd_surface()
    runs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            sim = JSim.build(jtypes.SYSTEM_2, japps, jsurfs, n_nodes=N_NODES, seed=0)
            scen_cls, app_cls, surf, apps = JScenario, jtypes.AppSpec, new_j, japps
            ctrl = j_make_controller("ecoshift", jtypes.SYSTEM_2, solver="pallas")
        else:
            sim = ClusterSim.build(
                types.SYSTEM_2, tapps, tsurfs, n_nodes=N_NODES, seed=0, device=CPU
            )
            scen_cls, app_cls, surf, apps = Scenario, types.AppSpec, new_t, tapps
            ctrl = make_controller(
                "ecoshift", types.SYSTEM_2, solver="pallas", device=CPU
            )
        _, recv, _ = sim.partition()
        scen = (
            _scenario(scen_cls, recv)
            .with_arrival(1, apps[0], caps=(350.0, 325.0))
            .with_arrival(2, app_cls(name="newapp", sclass="C", surface_id="newapp"),
                          surface=surf)
            .with_phase_change(2, recv[2].node_id, apps[1].name)
        )
        runs.append(sim.run(scen, ctrl))
    _assert_records_equal(runs[1], runs[0])


def test_slice_from_reference_node_columns(suites):
    """A port sim built from the reference sim's NodeTable columns replays
    the reference scenario bit for bit."""
    jsim, want = _reference_run(suites, "pallas", True)
    fresh = JSim.build(
        jtypes.SYSTEM_2, suites[0][0], suites[0][1], n_nodes=N_NODES, seed=0
    )
    jt = fresh.table
    table = node_table_from_columns(
        {name: getattr(jt, name) for name in COLUMNS}, list(jt.strings)
    )
    assert table.names == jt.names
    sim = ClusterSim(types.SYSTEM_2, surfaces=suites[1][1], seed=0, table=table,
                     device=CPU)
    _assert_records_equal(_port_run(sim, "pallas", True), want)
    # and the state it leaves matches the reference's
    for name in COLUMNS:
        assert getattr(sim.table, name).tobytes() == getattr(jsim.table, name).tobytes()


def test_node_table_from_columns_rejects_bad_columns():
    cols = {name: np.zeros(2, dtype=dtype) for name, dtype in COLUMNS.items()}
    cols["caps"] = np.zeros((2, 2))
    node_table_from_columns(cols, ["a"])
    with pytest.raises(KeyError, match="missing"):
        node_table_from_columns({"caps": cols["caps"]}, ["a"])
    with pytest.raises(ValueError, match="equal length"):
        node_table_from_columns({**cols, "alive": np.ones(3, bool)}, ["a"])


@pytest.mark.parametrize("solver", ["pallas", "jax"])
def test_policy_and_emulator_match_reference(suites, solver):
    (japps, jsurfs), (tapps, tsurfs) = suites
    jem = jemulator.ClusterEmulator.build(
        jtypes.SYSTEM_2, japps, jsurfs, n_nodes=24, seed=3
    )
    tem = emulator.ClusterEmulator.build(
        types.SYSTEM_2, tapps, tsurfs, n_nodes=24, seed=3, device=CPU
    )
    jem.add_straggler(5, 1.5)
    tem.add_straggler(5, 1.5)
    want = jem.run_round("ecoshift", 600.0, solver=solver)
    got = tem.run_round("ecoshift", 600.0, solver=solver)
    assert dict(got.allocation.caps) == dict(want.allocation.caps)
    assert got.improvements == want.improvements

    _, jrecv, _ = jem.partition()
    _, trecv, _ = tem.partition()
    jbase = {n.app.name: n.caps for n in jrecv}
    tbase = {n.app.name: n.caps for n in trecv}
    jseen = {n.app.name: jem._surface(n) for n in jrecv}
    tseen = {n.app.name: tem._surface(n) for n in trecv}
    for grouped in (True, False):
        want = jpolicies.ecoshift(
            [n.app for n in jrecv], jbase, 500.0, jtypes.SYSTEM_2, jseen,
            solver=solver, grouped=grouped,
        )
        got = policies.ecoshift(
            [n.app for n in trecv], tbase, 500.0, types.SYSTEM_2, tseen,
            solver=solver, grouped=grouped, device=CPU,
        )
        assert dict(got.caps) == dict(want.caps)
        assert got.spent == want.spent
        assert got.predicted_improvement == want.predicted_improvement


@pytest.mark.parametrize("solver", ["pallas", "jax"])
def test_allocate_batch_matches_reference(suites, solver):
    (japps, jsurfs), (tapps, tsurfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_2, japps, jsurfs, n_nodes=20, seed=8)
    tsim = ClusterSim.build(types.SYSTEM_2, tapps, tsurfs, n_nodes=20, seed=8, device=CPU)
    budgets = (150.0, 420.5, 900.0)
    results = []
    for sim, make, sys_, kw in (
        (jsim, j_make_controller, jtypes.SYSTEM_2, {}),
        (tsim, make_controller, types.SYSTEM_2, {"device": CPU}),
    ):
        _, recv, _ = sim.partition()
        ctrl = make("ecoshift", sys_, solver=solver, **kw)
        results.append(
            ctrl.allocate_batch(
                [n.app for n in recv],
                {n.app.name: n.caps for n in recv},
                budgets,
                {n.app.name: sim._surface(n) for n in recv},
            )
        )
    for got, want in zip(*reversed(results)):
        assert dict(got.caps) == dict(want.caps)
        assert got.spent == want.spent
        assert got.predicted_improvement == want.predicted_improvement


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "need = {'repro_torch.core.ncf', 'repro_torch.core.allocator', 'repro_torch.core.profiler',\n"
        "        'repro_torch.train.optimizer', 'repro_torch.cluster.predictor',\n"
        "        'repro_torch.core.topology', 'repro_torch.cluster.budget'}\n"
        "missing = sorted(need - set(mods))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 15 else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_none_needs_a_card(monkeypatch, suites):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (apps, surfs) = suites
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterSim.build(types.SYSTEM_2, apps, surfs, n_nodes=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_controller("ecoshift", types.SYSTEM_2, solver="pallas")
    _, tg = _random_groups(np.random.default_rng(0), 100.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mckp.solve_dense_jax_grouped(tg, 100.0, backend="pallas")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_paths_raise(suites):
    """What still raises on the controller path: an unknown solver, and a
    flat allocation asked of the hierarchical controller.  The MPC and
    fault entry points that used to raise here (ROADMAP.md, queue 1, item
    5) now run; tests/test_torch_faults.py and tests/test_torch_mpc.py
    hold them against the reference."""
    _, (apps, surfs) = suites
    sysm = types.SYSTEM_2
    with pytest.raises(ValueError, match="unknown solver"):
        make_controller("ecoshift", sysm, solver="cuda", device=CPU)
    for kw in ({"solver": "pallas", "horizon": 4}, {"horizon": 2}):
        assert make_controller("ecoshift", sysm, device=CPU, **kw).horizon == kw["horizon"]
    assert Scenario.constant(2).with_faults(()).faults == ()
    assert Scenario.constant(2).with_fault_storm(seed=0).faults == ()
    ctrl = make_controller("ecoshift", sysm, solver="dense", device=CPU)
    assert isinstance(ctrl.config, tcontroller.ControllerConfig)
    # the flat controller is not hierarchical: the engine never hands it a
    # domain tree (the hierarchical path is ecoshift_hier's)
    assert not getattr(ctrl, "supports_hierarchical", False)
    hier = make_controller("ecoshift_hier", sysm, device=CPU, horizon=3)
    with pytest.raises(ValueError, match="ecoshift_hier allocates per power domain"):
        hier.allocate_grouped(None, 1.0)
    for c in (ctrl, hier):
        assert c.snapshot() == {"policy": c.policy, "pins": {}, "pin_round": -1}
        c.set_budget_outlook([1.0])
        assert c._outlook == ((1.0,), None)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("grouped", [True, False])
def test_slice_on_card_matches_plain_version(cuda, suites, grouped):
    from repro_torch.kernels import mckp_dp

    _, (apps, surfs) = suites
    runs = {}
    for solver in ("pallas", "jax"):
        sim = ClusterSim.build(
            types.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0, device=cuda
        )
        mckp_dp.reset_launches()
        runs[solver] = _port_run(sim, solver, grouped, device=cuda)
        if solver == "pallas":
            stages = sum(len(r.result.improvements) for r in runs[solver].records)
            name = "maxplus_conv_batched" if grouped else "maxplus_conv"
            assert mckp_dp.launches[name] == stages
    _assert_records_equal(runs["pallas"], runs["jax"])


def test_jax_stays_on_cpu_with_x64_off():
    assert jax.default_backend() == "cpu"
    assert not jax.config.jax_enable_x64
