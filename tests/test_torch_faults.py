"""The port's fault paths against the JAX package, bit for bit.

* ``fault_storm`` event tuples (event type names and fields) and
  ``validate_faults``' errors, on tests/test_faults.py's rates and seeds;
* ``corrupt_batch`` and the injector's telemetry routing (drop, delay,
  stale repeat, corruption) and actuation plans;
* ``ClusterSim.run`` records under storms and crashes — allocations,
  measured improvements, the settled telemetry, ``domain_draw`` and the
  PowerGuard columns (``overdraw_w``, ``derate_w``, ``excursion_domains``,
  ``nacked``, ``telemetry_faults``) — for ``ecoshift`` (host, fused, the
  ``dense`` and ``jax`` solvers), ``ecoshift_hier`` (host, fused), ``dps``
  and the Oracle's pins, and with every warm cache bounded to 1;
* restored == uninterrupted, the NACK pin book, and the snapshot codec:
  its bytes against ``msgpack.packb``, and a file the reference wrote
  restoring a port controller.

The reference's fused path raises on this jax version, so the port's
fused rounds are held against the reference's host rounds (which the
reference certifies equal to its fused ones).  Inputs come from numpy
seeds; tolerance zero everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import PowerTopology as JTopology
from repro.cluster import Scenario as JScenario
from repro.cluster import controller as jcontroller
from repro.cluster import faults as jfaults
from repro.cluster.predictor import TelemetryBatch as JTelemetryBatch
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro_torch import interop
from repro_torch.cluster import ClusterSim, Scenario
from repro_torch.cluster import controller as pcontroller
from repro_torch.cluster import faults
from repro_torch.cluster.controller import ControllerConfig, make_controller
from repro_torch.cluster.predictor import TelemetryBatch
from repro_torch.core import surfaces, types
import test_faults as jtest_faults

torch.set_num_threads(1)
CPU = "cpu"
BUDGETS = jtest_faults.BUDGETS

#: tests/test_faults.py's heaviest storm (its end-to-end case)
STORM = dict(
    telemetry_drop=0.15, telemetry_delay=0.2, telemetry_corrupt=0.35,
    telemetry_stale=0.15, actuation_nack=0.4, actuation_partial=0.25,
    actuation_delay=0.25, node_fraction=0.35,
)


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


def _events(evs):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in evs]


def _assert_records_equal(got, want):
    """Every record field both packages share, with ``==`` (the
    telemetry's arrays bitwise, NaN where corruption put one)."""
    assert len(got.records) == len(want.records)
    for rg, rw in zip(got.records, want.records):
        ag, aw = rg.result.allocation, rw.result.allocation
        assert dict(ag.caps) == dict(aw.caps), rg.round
        assert ag.spent == aw.spent, rg.round
        assert np.float64(ag.predicted_improvement).tobytes() == np.float64(
            aw.predicted_improvement
        ).tobytes()
        assert rg.result.improvements == rw.result.improvements, rg.round
        assert rg.result.budget == rw.result.budget
        assert rg.pool == rw.pool and rg.n_alive == rw.n_alive
        assert rg.domain_draw == rw.domain_draw, rg.round
        assert rg.domain_caps == rw.domain_caps
        for f in ("overdraw_w", "derate_w", "excursion_domains", "nacked",
                  "telemetry_faults"):
            assert getattr(rg, f) == getattr(rw, f), (f, rg.round)
        tg, tw = rg.telemetry, rw.telemetry
        for f in ("baseline_caps", "allocated_caps", "t_baseline",
                  "t_allocated", "improvement"):
            assert np.asarray(getattr(tg, f)).tobytes() == np.asarray(
                getattr(tw, f)
            ).tobytes(), (f, rg.round)


def _pair(suites, n, seed, n_rounds, budgets, *, rack_extra=None, faults_=None,
          storm=None, initial=None):
    """(reference, port) sims and scenarios: the same cluster, budgets,
    optional three-rack topology (each rack at its committed draw plus
    ``rack_extra`` W), fault events given as (class name, kwargs) pairs,
    and an optional storm."""
    (japps, jsurfs), (apps, surfs) = suites
    kw = {} if initial is None else {"initial_caps": initial}
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=seed, **kw)
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=seed,
                           device=CPU, **kw)
    js = JScenario(n_rounds, budget=budgets)
    ts = Scenario(n_rounds, budget=budgets)
    if rack_extra is not None:
        committed = float(jsim.table.caps.sum())
        jtopo = JTopology.uniform_racks(n, 3, rack_cap=committed / 3 + rack_extra)
        js = js.with_topology(jtopo)
        ts = ts.with_topology(interop.topology_from_parts(jtopo))
    if faults_:
        js = js.with_faults([getattr(jfaults, c)(**k) for c, k in faults_])
        ts = ts.with_faults([getattr(faults, c)(**k) for c, k in faults_])
    if storm is not None:
        js = js.with_fault_storm(**storm)
        ts = ts.with_fault_storm(**storm)
    return jsim, sim, js, ts


# ---------------------------------------------------------------------------
# Events, validation, storms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 8, 11, 17, 23, 40, 41])
def test_fault_storm_matches_reference(seed):
    kw = dict(STORM, crash_rounds=(5, 10))
    got = faults.fault_storm(20, seed, **kw)
    assert _events(got) == _events(jfaults.fault_storm(20, seed, **kw))
    assert got == faults.fault_storm(20, seed, **kw)


@pytest.mark.parametrize("rate", [0.05, 0.15, 0.30])
def test_benchmark_storm_rates_match_reference(rate):
    """benchmarks/fault_storm.py's storm at each swept rate (seed 17)."""
    kw = dict(
        telemetry_drop=rate / 2, telemetry_delay=rate / 2,
        telemetry_corrupt=rate, telemetry_stale=rate / 2,
        actuation_nack=rate, actuation_partial=rate,
        actuation_delay=rate / 2, node_fraction=0.3,
    )
    got = Scenario(24, budget=1.0).with_fault_storm(seed=17, **kw).faults
    want = JScenario(24, budget=1.0).with_fault_storm(seed=17, **kw).faults
    assert _events(got) == _events(want)


@pytest.mark.parametrize(
    "bad",
    [
        ("TelemetryDrop", {"round": 9}),
        ("TelemetryCorrupt", {"round": 0, "mode": "zap"}),
        ("TelemetryCorrupt", {"round": 0, "fraction": 0.0}),
        ("ActuationNack", {"round": 0}),
        ("ActuationPartial", {"round": 0, "fraction": 0.5, "applied_fraction": 2.0}),
        ("TelemetryDelay", {"round": 0, "rounds": 0}),
        ("TelemetryStale", {"round": 1, "age": 0}),
    ],
)
def test_validate_faults_raises_like_reference(bad):
    name, kw = bad
    with pytest.raises(ValueError) as want:
        jfaults.validate_faults([getattr(jfaults, name)(**kw)], 4)
    with pytest.raises(ValueError) as got:
        faults.validate_faults([getattr(faults, name)(**kw)], 4)
    assert str(got.value) == str(want.value)


def test_unknown_fault_and_timeline_fault_fail_fast(suites):
    from repro_torch.cluster.scenario import NodeFailure

    with pytest.raises(TypeError, match="NodeFailure"):
        Scenario.constant(4).with_faults([NodeFailure(round=1, node_ids=(0,))])
    _, (apps, surfs) = suites
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=8, device=CPU)
    with pytest.raises(TypeError, match="with_faults"):
        sim.apply_events([faults.TelemetryDrop(round=0)])
    a, b = faults.TelemetryDrop(round=1), faults.ActuationNack(round=2, fraction=0.5)
    assert Scenario.constant(4).with_faults([a]).with_faults([b]).faults == (a, b)


# ---------------------------------------------------------------------------
# Telemetry and actuation channels
# ---------------------------------------------------------------------------


def _batches(round=0, n=8, seed=0):
    """The same tiny batch in both packages (tests/test_faults.py's)."""
    rng = np.random.default_rng(seed)
    strings = tuple(f"i{j}" for j in range(n)) + ("app",)
    t0 = rng.uniform(50.0, 80.0, n)
    t1 = t0 * rng.uniform(0.6, 0.9, n)
    cols = dict(
        round=round, inst_gids=np.arange(n), app_gids=np.full(n, n),
        strings=strings, baseline_caps=np.full((n, 2), 100.0),
        allocated_caps=np.full((n, 2), 120.0), t_baseline=t0,
        t_allocated=t1, improvement=(t0 - t1) / t0,
    )
    return JTelemetryBatch(**cols), TelemetryBatch(**cols)


def _batch_bytes(b):
    return tuple(
        np.asarray(getattr(b, f)).tobytes()
        for f in ("t_baseline", "t_allocated", "improvement")
    ) + (b.round,)


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_corrupt_batch_matches_reference(mode, seed):
    jb, b = _batches(n=16, seed=seed)
    orig = _batch_bytes(b)
    ev = dict(round=0, fraction=0.3, mode=mode, seed=seed + 1)
    got = faults.corrupt_batch(b, faults.TelemetryCorrupt(**ev))
    want = jfaults.corrupt_batch(jb, jfaults.TelemetryCorrupt(**ev))
    assert _batch_bytes(got) == _batch_bytes(want)
    assert _batch_bytes(b) == orig  # copy-on-write
    assert _batch_bytes(got) != orig


def test_injector_delivery_matches_reference():
    evs = [
        ("TelemetryDrop", {"round": 0}),
        ("TelemetryDelay", {"round": 1, "rounds": 2}),
        ("TelemetryCorrupt", {"round": 2, "fraction": 0.5, "mode": "outlier", "seed": 4}),
        ("TelemetryStale", {"round": 4, "age": 2}),
        ("TelemetryCorrupt", {"round": 5, "fraction": 0.25, "mode": "negative"}),
        ("TelemetryDelay", {"round": 5}),
        ("TelemetryDrop", {"round": 6}),
        ("TelemetryStale", {"round": 6, "age": 1}),
    ]
    jinj = jfaults.FaultInjector([getattr(jfaults, c)(**k) for c, k in evs])
    inj = faults.FaultInjector([getattr(faults, c)(**k) for c, k in evs])
    for r in range(8):
        jb, b = _batches(round=r, seed=r)
        jout, jk = jinj.deliver(r, jb)
        out, k = inj.deliver(r, b)
        assert k == jk, r
        assert [_batch_bytes(x) for x in out] == [_batch_bytes(x) for x in jout], r


def test_actuation_plan_matches_reference():
    evs = [
        ("ActuationNack", {"round": 1, "fraction": 0.3, "seed": 2}),
        ("ActuationPartial", {"round": 1, "fraction": 0.5, "seed": 3,
                              "applied_fraction": 0.25}),
        ("ActuationDelay", {"round": 1, "node_ids": (4, 9, 17)}),
    ]
    jinj = jfaults.FaultInjector([getattr(jfaults, c)(**k) for c, k in evs])
    inj = faults.FaultInjector([getattr(faults, c)(**k) for c, k in evs])
    names = [f"n{i}" for i in range(24)]
    ids = np.arange(24)
    assert inj.actuation_plan(1, names, ids) == jinj.actuation_plan(1, names, ids)
    assert inj.has_actuation(1) and not inj.has_actuation(0)


# ---------------------------------------------------------------------------
# ClusterSim.run under storms
# ---------------------------------------------------------------------------


#: controller kwargs per case: (policy, port kwargs, reference kwargs, racks)
STORM_CASES = {
    "ecoshift": ("ecoshift", {}, {}, None),
    "ecoshift_fused": ("ecoshift", {"fused": True}, {}, None),
    "ecoshift_dense": ("ecoshift", {"solver": "dense"}, {"solver": "dense"}, None),
    "ecoshift_jax": ("ecoshift", {"solver": "jax"}, {"solver": "jax"}, None),
    "hier": ("ecoshift_hier", {}, {}, 450.0),
    "hier_fused": ("ecoshift_hier", {"fused": True}, {}, 450.0),
    "dps": ("dps", {}, {}, None),
}


@pytest.mark.parametrize("case", list(STORM_CASES))
@pytest.mark.parametrize("seed", [11, 12])
def test_storm_records_match_reference(suites, case, seed):
    """tests/test_faults.py's end-to-end storm (two crashes) over 14
    rounds of a varying budget: the port's records equal the reference's,
    every settled domain draw at or under its cap, and NACK rounds occur."""
    policy, kw, jkw, rack_extra = STORM_CASES[case]
    jsim, sim, js, ts = _pair(
        suites, 24, 3, 14, (BUDGETS + BUDGETS)[:14], rack_extra=rack_extra,
        storm=dict(STORM, seed=seed, crash_rounds=(5, 10)),
    )
    want = jsim.run(js, jcontroller.make_controller(policy, jtypes.SYSTEM_1, **jkw))
    ctrl = make_controller(policy, types.SYSTEM_1, device=CPU, **kw)
    got = sim.run(ts, ctrl)
    _assert_records_equal(got, want)
    assert any(r.nacked for r in got.records)
    for rec in got.records:
        extra = float(np.sum(rec.telemetry.allocated_caps) - np.sum(rec.telemetry.baseline_caps))
        assert extra <= rec.result.budget + 1e-6
        for d, w in (rec.domain_draw or {}).items():
            assert w <= rec.domain_caps[d] + 1e-6
    if kw.get("fused"):
        assert ctrl.fused_stats().rounds > 0


def test_oracle_pins_match_reference(suites):
    """The Oracle's pinned rounds (brute force on <= 10 receivers, budgets
    of a few hundred watts)."""
    jsim, sim, js, ts = _pair(
        suites, 10, 5, 6, [300.0, 120.0, 260.0, 150.0, 300.0, 200.0],
        faults_=[
            ("ActuationNack", {"round": 1, "fraction": 0.4, "seed": 2}),
            ("ActuationPartial", {"round": 3, "fraction": 0.3, "seed": 5}),
            ("ActuationNack", {"round": 4, "fraction": 0.3, "seed": 1}),
        ],
    )
    want = jsim.run(js, jcontroller.make_controller("oracle", jtypes.SYSTEM_1))
    got = sim.run(ts, make_controller("oracle", types.SYSTEM_1, device=CPU))
    _assert_records_equal(got, want)
    assert any(r.nacked for r in got.records)


@pytest.mark.parametrize("kind", ["nack", "partial", "delay"])
def test_actuation_semantics_match_reference(suites, kind):
    """tests/test_faults.py's actuation cases under ``dps`` and under
    ``ecoshift`` (whose pins then steer the next round)."""
    ev = {
        "nack": ("ActuationNack", {"round": 1, "fraction": 1.0, "seed": 1}),
        "partial": ("ActuationPartial", {"round": 1, "fraction": 1.0,
                                         "applied_fraction": 0.25}),
        "delay": ("ActuationDelay", {"round": 1, "fraction": 1.0}),
    }[kind]
    for policy in ("dps", "ecoshift"):
        jsim, sim, js, ts = _pair(suites, 24, 3, 4, [700.0, 1500.0, 1000.0, 1500.0],
                                  faults_=[ev])
        want = jsim.run(js, jcontroller.make_controller(policy, jtypes.SYSTEM_1))
        got = sim.run(ts, make_controller(policy, types.SYSTEM_1, device=CPU))
        _assert_records_equal(got, want)
        assert got.records[1].nacked


def test_forced_domain_excursion_matches_reference(suites):
    """A rack cap collapsing under a full NACK: PowerGuard claws the stuck
    draw back in the same round, as in the reference."""
    (japps, jsurfs), (apps, surfs) = suites
    jsim = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=24, seed=3)
    sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=24, seed=3, device=CPU)
    jtopo = JTopology.uniform_racks(24, 3, rack_cap=1e6)
    committed0 = float(jsim.table.caps.sum()) / 3
    js = (JScenario(4, budget=900.0).with_topology(jtopo)
          .with_domain_cap(2, "rack0", committed0 + 50.0)
          .with_faults([jfaults.ActuationNack(round=2, fraction=1.0)]))
    ts = (Scenario(4, budget=900.0).with_topology(interop.topology_from_parts(jtopo))
          .with_domain_cap(2, "rack0", committed0 + 50.0)
          .with_faults([faults.ActuationNack(round=2, fraction=1.0)]))
    want = jsim.run(js, jcontroller.make_controller("ecoshift_hier", jtypes.SYSTEM_1))
    got = sim.run(ts, make_controller("ecoshift_hier", types.SYSTEM_1, device=CPU))
    _assert_records_equal(got, want)
    rec = got.records[2]
    assert "rack0" in rec.excursion_domains and rec.overdraw_w > 0 and rec.derate_w > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_deep_tree_storm_matches_reference(suites, seed):
    """tests/test_faults.py's deep-tree storm: the port's fused and host
    rounds against the reference's host rounds; every level capped and no
    excursion carried into the next round."""
    (japps, jsurfs), (apps, surfs) = suites
    n = 48
    jtopo = jtest_faults.TestDeepTreeFusedStorm._deep_topology(jtypes.SYSTEM_1, japps, jsurfs, n)
    topo = interop.topology_from_parts(jtopo)
    budgets = [2000.0, 900.0, 1600.0, 700.0, 2000.0, 1100.0, 1800.0, 800.0]
    storm = dict(
        seed=40 + seed, telemetry_drop=0.1, telemetry_corrupt=0.3,
        telemetry_stale=0.1, actuation_nack=0.35, actuation_partial=0.25,
        actuation_delay=0.2, node_fraction=0.3, crash_rounds=(3,),
    )
    js = JScenario(len(budgets), budget=budgets).with_topology(jtopo).with_fault_storm(**storm)
    ts = Scenario(len(budgets), budget=budgets).with_topology(topo).with_fault_storm(**storm)
    want = JSim.build(jtypes.SYSTEM_1, japps, jsurfs, n_nodes=n, seed=0,
                      initial_caps=(150.0, 150.0), topology=jtopo).run(
        js, jcontroller.make_controller("ecoshift_hier", jtypes.SYSTEM_1))
    for fused in (False, True):
        sim = ClusterSim.build(types.SYSTEM_1, apps, surfs, n_nodes=n, seed=0,
                               initial_caps=(150.0, 150.0), topology=topo, device=CPU)
        ctrl = make_controller("ecoshift_hier", types.SYSTEM_1, fused=fused, device=CPU)
        got = sim.run(ts, ctrl)
        _assert_records_equal(got, want)
        prev_over = False
        for rec in got.records:
            for name, draw in rec.domain_draw.items():
                assert draw <= rec.domain_caps[name] + 1e-6
            over = rec.overdraw_w > 0.0
            assert not (over and prev_over)
            prev_over = over
        if fused:
            assert ctrl.fused_stats().fallbacks == 0


# ---------------------------------------------------------------------------
# Crashes, snapshots, pins, cache bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ecoshift", "ecoshift_fused", "hier", "hier_fused"])
@pytest.mark.parametrize("restore", [True, False])
def test_crash_replays_uninterrupted_run(suites, mode, restore):
    """A crash at round 4 (restored from the round-3 snapshot, or cold):
    the port's run equals its uninterrupted run and the reference's
    crashed run in every round, and a fused controller runs fused again
    after the crash on rebuilt banks."""
    policy, kw, _, rack_extra = STORM_CASES[mode]
    rack = None if rack_extra is None else 1e6
    crash = [("ControllerCrash", {"round": 4, "restore": restore})]
    runs = []
    for fs in (None, crash):
        jsim, sim, js, ts = _pair(suites, 24, 3, 8, BUDGETS[:8], rack_extra=rack,
                                  faults_=fs)
        ctrl = make_controller(policy, types.SYSTEM_1, device=CPU, **kw)
        runs.append((sim.run(ts, ctrl), ctrl))
    want = jsim.run(js, jcontroller.make_controller(policy, jtypes.SYSTEM_1))
    (clean, _), (crashed, ctrl) = runs
    _assert_records_equal(crashed, want)
    for a, b in zip(clean.records, crashed.records):
        assert dict(a.result.allocation.caps) == dict(b.result.allocation.caps)
        assert a.result.improvements == b.result.improvements
    if kw.get("fused"):
        st = ctrl.fused_stats()
        assert st.fallbacks == 0 and st.rebuilds >= 2


@pytest.mark.parametrize("policy", ["ecoshift", "ecoshift_hier"])
def test_tiny_cache_bounds_match_reference(suites, policy):
    """Every warm cache bounded to 1 (ControllerConfig.max_*) under a
    storm: the port's records equal the reference's default-bounded run."""
    tiny = dict(max_group_tables=1, max_agg_curves=1, max_picks=1, max_plans=1,
                max_allocations=1, max_frontiers=1)
    jsim, sim, js, ts = _pair(
        suites, 24, 3, 10, BUDGETS[:10],
        rack_extra=450.0 if policy == "ecoshift_hier" else None,
        storm=dict(STORM, seed=11, crash_rounds=(5,)),
    )
    want = jsim.run(js, jcontroller.make_controller(policy, jtypes.SYSTEM_1))
    ctrl = make_controller(policy, types.SYSTEM_1, device=CPU,
                           config=ControllerConfig(**tiny))
    got = sim.run(ts, ctrl)
    _assert_records_equal(got, want)
    assert ctrl._agg_curves.maxsize == 1 and ctrl._alloc_cache.maxsize == 1


def _report_sequence(mod):
    R = mod.ActuationReport
    return [
        R(round=0, acked=("b",), nacked=("a", "c"),
          applied={"a": (140.0, 180.0), "c": (100.0, 120.0)}),
        R(round=1, acked=("a",), nacked=("c",), applied={"c": (110.0, 120.0)}),
        R(round=2, acked=("a", "c"), nacked=("b",), applied={"b": (150.0, 200.0)}),
        R(round=3, acked=(), nacked=("c",), applied={"c": (90.0, 90.0)}),
        R(round=4, acked=(), nacked=("c",), applied={}),
        R(round=9, acked=("b", "c"), nacked=(), applied={}),
    ]


def test_pin_book_matches_reference(suites):
    """NACK pins, backoff and retry exhaustion on one report sequence; an
    invalidate drops a touched pin and snapshots carry the book."""
    jc = jcontroller.make_controller("ecoshift", jtypes.SYSTEM_1)
    pc = make_controller("ecoshift", types.SYSTEM_1, device=CPU)
    for jr, pr in zip(_report_sequence(jfaults), _report_sequence(faults)):
        jc.notify_actuation(jr)
        pc.notify_actuation(pr)
        assert pc._pins == jc._pins and pc._pin_round == jc._pin_round
        assert pc.snapshot() == jc.snapshot()
    assert pc._pins["c"]["fails"] == pc.NACK_MAX_RETRIES
    jc.invalidate(["c"])
    pc.invalidate(["c"])
    assert pc._pins == jc._pins
    pc.invalidate(None)
    assert not pc._pins and pc._pin_round == -1
    with pytest.raises(ValueError, match="policy"):
        pc.restore({"policy": "dps", "pins": {}, "pin_round": -1})


def _snapshot_tree():
    return {
        "policy": "ecoshift",
        "arr": np.arange(6, dtype=np.float64).reshape(2, 3),
        "i32": np.array([-5, 7, 1 << 20], dtype=np.int32),
        "tup": (1, 2.5, "x", None, True, False),
        "keys": {(0.5, 1.5): [3.0, 2], 7: "seven"},
        "nested": {"a": np.array([1.0, np.inf, -1.0, np.nan])},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 1 << 32, -1, -32, -33,
                 -128, -129, -32768, -32769, -(1 << 31) - 1, 10**9 + 3],
        "floats": [0.0, -0.0, 1e-300, 3.141592653589793, np.float64(2.5)],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "long": list(range(20)),
        "wide": {f"k{i}": i for i in range(20)},
    }


def test_snapshot_codec_bytes_equal_msgpack(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    tree = _snapshot_tree()
    path = tmp_path / "port.snap"
    pcontroller.save_snapshot(path, tree)
    assert path.read_bytes() == msgpack.packb(pcontroller._pack(tree), use_bin_type=True)
    assert path.read_bytes() == msgpack.packb(jcontroller._pack(tree), use_bin_type=True)
    out = pcontroller.load_snapshot(path)
    want = jcontroller.load_snapshot(path)
    assert out.keys() == want.keys()
    assert out["tup"] == want["tup"] == tree["tup"]
    assert out["keys"] == want["keys"] == tree["keys"]
    assert out["ints"] == tree["ints"] and out["strs"] == tree["strs"]
    assert out["bins"] == tree["bins"] and out["wide"] == tree["wide"]
    for k in ("arr", "i32"):
        assert out[k].dtype == tree[k].dtype and np.array_equal(out[k], tree[k])
    assert out["nested"]["a"].tobytes() == tree["nested"]["a"].tobytes()
    assert [np.float64(x).tobytes() for x in out["floats"]] == [
        np.float64(x).tobytes() for x in tree["floats"]
    ]
    assert not (tmp_path / "port.snap.tmp").exists()


@pytest.mark.parametrize("policy", ["ecoshift", "ecoshift_hier"])
def test_reference_snapshot_file_restores_port_controller(suites, policy, tmp_path):
    """A snapshot the reference wrote (msgpack) after four faulted rounds
    restores a fresh port controller: its pins equal the warm port
    controller's, and the restored, the warm and the reference controllers
    allocate the next rounds alike."""
    pytest.importorskip("msgpack")
    head = 4
    jsim, sim, js, ts = _pair(
        suites, 24, 3, head, BUDGETS[:head],
        rack_extra=450.0 if policy == "ecoshift_hier" else None,
        faults_=[("ActuationNack", {"round": 2, "fraction": 0.3, "seed": 2}),
                 ("ActuationNack", {"round": 3, "fraction": 0.3, "seed": 4})],
    )
    jc = jcontroller.make_controller(policy, jtypes.SYSTEM_1)
    pc = make_controller(policy, types.SYSTEM_1, device=CPU)
    jsim.run(js, jc)
    sim.run(ts, pc)
    path = tmp_path / "ref.snap"
    jcontroller.save_snapshot(path, jc.snapshot())
    assert pcontroller.load_snapshot(path) == pc.snapshot()
    restored = make_controller(policy, types.SYSTEM_1, device=CPU)
    restored.restore(pcontroller.load_snapshot(path))
    assert restored._pins and restored._pins == pc._pins
    assert restored._pin_round == pc._pin_round
    for r in range(head, 8):
        want = jsim.run_round(jc, budget=BUDGETS[r], round_index=r)
        for ctrl in (pc, restored):
            got = sim.run_round(ctrl, budget=BUDGETS[r], round_index=r)
            assert dict(got.allocation.caps) == dict(want.allocation.caps), r
            assert got.improvements == want.improvements


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
def test_storm_on_card_matches_host(cuda, suites, policy):
    """Fused rounds on the card (kernel 2.1) under a storm with a crash:
    records equal the port's host rounds."""
    runs = []
    for kw in ({"fused": True}, {}):
        _, sim, _, ts = _pair(
            suites, 24, 3, 14, (BUDGETS + BUDGETS)[:14],
            rack_extra=450.0 if policy == "ecoshift_hier" else None,
            storm=dict(STORM, seed=11, crash_rounds=(5, 10)),
        )
        sim.device = cuda
        ctrl = make_controller(policy, types.SYSTEM_1, device=cuda, **kw)
        runs.append((sim.run(ts, ctrl), ctrl))
    (fused, ctrl), (host, _) = runs
    _assert_records_equal(fused, host)
    assert ctrl.fused_stats().fallbacks == 0 and ctrl.fused_stats().rounds > 0
