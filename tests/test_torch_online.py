"""The port's AdamW, NCF predictor and online prediction loop against the
JAX package.

The reference draws its initial parameters, embeddings and minibatch
indices from ``jax.random``; the port draws its own from
``torch.Generator``s and takes injected ones, so these tests hand it the
reference's arrays (computed here with ``jax.random``) and hold the
float32 results within stated tolerances.  Everything the online loop does
on the host (telemetry buffers, pooling, the robust-ingest gate, the
controllers' records on equal served surfaces) is compared exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import OnlinePredictor as JOnline
from repro.cluster import OnlinePredictorConfig as JOnlineCfg
from repro.cluster import Scenario as JScenario
from repro.cluster import TelemetryRecord as JRecord
from repro.cluster.controller import make_controller as j_make_controller
from repro.cluster.faults import TelemetryCorrupt, corrupt_batch
from repro.core import ncf as jncf
from repro.core import profiler as jprofiler
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro.core.allocator import EcoShiftAllocator as JAllocator
from repro.train import optimizer as jopt
from repro_torch.cluster import (
    ClusterSim,
    OnlinePredictor,
    OnlinePredictorConfig,
    Scenario,
    TelemetryBatch,
    TelemetryRecord,
)
from repro_torch.cluster.controller import make_controller
from repro_torch.core import ncf, surfaces, types
from repro_torch.core.allocator import EcoShiftAllocator
from repro_torch.interop import ncf_predictor_from_parts
from repro_torch.train import optimizer as opt

# tiny shapes: one intra-op thread keeps this file off the other workers
torch.set_num_threads(1)
CPU = "cpu"
#: small config: parity needs no benchmark-grade accuracy
FAST = dict(train_steps=30, online_steps=20, embed_dim=8)
#: float32 tolerances, set from the dtype before the first run: one
#: forward pass (a few ulps of its outputs), and trajectories of tens of
#: AdamW steps whose float32 rounding differs between the two packages
FWD_TOL = 1e-6
FIT_TOL = 1e-5
#: the reference's own tolerance for the stacked against the sequential
#: online fit (tests/test_online_predictor.py::test_batched_matches_sequential)
STACKED_TOL = 1e-4
N_TRAIN = 8


def _np(tree):
    return opt.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _max_err(a, b) -> float:
    la = jax.tree.leaves(jax.device_get(a))
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, big: bool):
    out = {
        "w": rng.normal(size=(6, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
        "layers": [{"k": rng.normal(size=(3, 4, 2)).astype(np.float32)}],
    }
    if big:  # one leaf large enough for chunked updates (>= 2**22 elements)
        out["stack"] = rng.normal(size=(4, 1024, 1024)).astype(np.float32)
    return out


ADAMW_CASES = {
    "plain": dict(learning_rate=1e-2),
    "decay_mask_clip": dict(
        learning_rate=1e-2, weight_decay=0.1, max_grad_norm=0.5,
        mask=lambda p: {"w": True, "b": False, "layers": [{"k": True}]},
    ),
    "factored": dict(learning_rate=1e-2, factored=True),
    "schedule": dict(learning_rate="warmup_cosine"),
    "chunked_factored": dict(learning_rate=1e-2, factored=True, update_chunks=2),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_matches_reference(case):
    kw = dict(ADAMW_CASES[case])
    big = case.startswith("chunked")
    if kw["learning_rate"] == "warmup_cosine":
        kw_j = dict(kw, learning_rate=jopt.warmup_cosine(1e-2, 2, 6))
        kw_t = dict(kw, learning_rate=opt.warmup_cosine(1e-2, 2, 6))
    else:
        kw_j = kw_t = kw
    rng = np.random.default_rng(0)
    params = _tree(rng, big)
    jo, to = jopt.adamw(**kw_j), opt.adamw(**kw_t)
    jp, tp = params, opt.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2 if big else 6):
        g = _tree(rng, big)
        jp, js = jo.update(g, js, jp)
        tp, ts = to.update(opt.tree_map(torch.from_numpy, g), ts, tp)
    assert int(ts.step) == int(js.step)
    assert _max_err(jp, _np(tp)) <= FIT_TOL
    assert _max_err(js.mu, _np(ts.mu)) <= FIT_TOL
    assert _max_err(js.nu, _np(ts.nu)) <= FIT_TOL


def test_global_norm_and_clip_match_reference():
    g = _tree(np.random.default_rng(1), False)
    tg = opt.tree_map(torch.from_numpy, g)
    assert abs(float(opt.global_norm(tg)) - float(jopt.global_norm(g))) <= FWD_TOL
    jc, jn = jopt.clip_by_global_norm(g, 1.0)
    tc, tn = opt.clip_by_global_norm(tg, 1.0)
    assert abs(float(tn) - float(jn)) <= FWD_TOL
    assert _max_err(jc, _np(tc)) <= FWD_TOL
    steps = np.arange(0, 9, dtype=np.int32)
    np.testing.assert_allclose(
        opt.warmup_cosine(1e-2, 2, 6)(torch.from_numpy(steps)).numpy(),
        np.asarray(jopt.warmup_cosine(1e-2, 2, 6)(jax.numpy.asarray(steps))),
        rtol=0, atol=FWD_TOL,
    )


# ---------------------------------------------------------------------------
# NCF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """The reference trained on 8 apps of SYSTEM_2 (observations from the
    seeded dense profile), and the port's predictor carrying its weights
    and its initial-embedding draws."""
    jsys, tsys = jtypes.SYSTEM_2, types.SYSTEM_2
    japps, jsurfs = jsurfaces.build_paper_suite(jsys)
    tapps, tsurfs = surfaces.build_paper_suite(tsys)
    jcfg = jncf.NCFConfig(**FAST)
    hist = {a.name: jsurfs[a.name] for a in japps[:N_TRAIN]}
    jalloc = JAllocator.train_offline(jsys, hist, jcfg)
    for a in japps[:N_TRAIN]:
        jalloc.onboard_known(a.name)
    jp = jalloc.predictor
    tp = ncf_predictor_from_parts(
        tsys, jcfg, jp.params, jp.app_index, jp.cfg_feats, device=CPU,
        embedding_init=lambda name: jax.device_get(jp._init_embedding(name)),
    )
    return dict(jsys=jsys, tsys=tsys, japps=japps, tapps=tapps, jsurfs=jsurfs,
                tsurfs=tsurfs, jalloc=jalloc, jp=jp, tp=tp)


def _reference_streams(jsys, observations, cfg):
    """The reference fit's initial parameters and index stream, replayed
    with ``jax.random`` exactly as ``repro.core.ncf.NCFPredictor.fit`` draws
    them."""
    n_obs = sum(len(o) for o in observations.values())
    init = jax.device_get(
        jncf._init_params(jax.random.PRNGKey(cfg.seed), len(observations),
                          len(jsys.grid.pairs()), cfg)
    )
    key, idx = jax.random.PRNGKey(cfg.seed + 1), []
    for _ in range(cfg.train_steps):
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (cfg.batch_size,), 0, n_obs)))
    return init, np.stack(idx)


def _observations(jsys, jsurfs, apps):
    rng = np.random.default_rng(0)
    return {a.name: jprofiler.dense_profile(jsurfs[a.name], jsys, rng=rng) for a in apps}


def test_forward_matches_reference(trained):
    jp, tp = trained["jp"], trained["tp"]
    rng = np.random.default_rng(3)
    app_ids = rng.integers(0, len(jp.app_index), size=64)
    cfg_ids = rng.integers(0, len(jp.cfg_feats), size=64)
    want = np.asarray(jncf._forward(jax.device_get(jp.params), app_ids, cfg_ids,
                                    jp.cfg_feats[cfg_ids]))
    got = ncf._forward(tp.params, torch.from_numpy(app_ids), torch.from_numpy(cfg_ids),
                       torch.from_numpy(jp.cfg_feats[cfg_ids])).numpy()
    assert got.dtype == np.float32
    assert float(np.max(np.abs(got - want))) <= FWD_TOL


def test_carried_weights_predict_like_reference(trained):
    jp, tp = trained["jp"], trained["tp"]
    assert tp.app_index == jp.app_index
    for name in jp.app_index:
        want = jp.predict_log_ratios(name)
        got = tp.predict_log_ratios(name)
        assert got.dtype == want.dtype == np.float32
        assert float(np.max(np.abs(got - want))) <= FWD_TOL
    jsurf, tsurf = jp.predict_surface(name), tp.predict_surface(name)
    assert tsurf.table.dtype == jsurf.table.dtype == np.float32
    np.testing.assert_allclose(tsurf.table, jsurf.table, rtol=FWD_TOL, atol=0)


def test_fit_matches_reference_on_injected_streams(trained):
    jsys, tsys, japps, jsurfs = (trained[k] for k in ("jsys", "tsys", "japps", "jsurfs"))
    obs = _observations(jsys, jsurfs, japps[:6])
    jcfg = jncf.NCFConfig(**FAST)
    init, idx = _reference_streams(jsys, obs, jcfg)
    want = jncf.NCFPredictor.fit(jsys, obs, jcfg)
    got = ncf.NCFPredictor.fit(tsys, obs, ncf.NCFConfig(**FAST), device=CPU,
                               init_params=init, indices=idx)
    assert got.app_index == want.app_index
    assert _max_err(want.params, _np(got.params)) <= FIT_TOL
    with pytest.raises(ValueError, match="indices must be"):
        ncf.NCFPredictor.fit(tsys, obs, ncf.NCFConfig(**FAST), device=CPU,
                             init_params=init, indices=idx[:-1])


def test_infer_and_update_apps_match_reference(trained):
    jp, tp, jsys, jsurfs, japps = (trained[k] for k in ("jp", "tp", "jsys", "jsurfs", "japps"))
    sa = jprofiler.profile_app(jsurfs[japps[30].name], jsys, n_samples=8, seed=3)
    sb = jprofiler.profile_app(jsurfs[japps[31].name], jsys, n_samples=6, seed=4)
    ji, ti = jp.infer_app("probe", sa), tp.infer_app("probe", sa)
    assert ti.app_index == ji.app_index
    assert float(np.max(np.abs(ti.predict_log_ratios("probe")
                               - ji.predict_log_ratios("probe")))) <= FIT_TOL
    ju, tu = jp.update_apps({"a": sa, "b": sb}), tp.update_apps({"a": sa, "b": sb})
    for n in ("a", "b"):
        err = np.abs(tu.predict_log_ratios(n) - ju.predict_log_ratios(n))
        assert float(np.max(err)) <= FIT_TOL
    assert tp.update_apps({}) is tp


@pytest.mark.parametrize("injected", [True, False])
def test_update_app_equals_infer_app_bitwise(trained, injected):
    tp = trained["tp"]
    if not injected:  # the port's own crc32-seeded draws
        tp = dataclasses.replace(tp, embedding_init=None)
    full = jprofiler.profile_app(trained["jsurfs"][trained["japps"][33].name],
                                 trained["jsys"], n_samples=8, seed=3)
    few = dict(list(full.items())[:4])
    scratch = tp.infer_app("probe", full)
    incremental = tp.infer_app("probe", few).update_app("probe", full)
    i, j = scratch.app_index["probe"], incremental.app_index["probe"]
    for key in ("app_gmf", "app_mlp"):
        assert torch.equal(scratch.params[key][i], incremental.params[key][j])
    assert scratch.predict_log_ratios("probe").tobytes() == \
        incremental.predict_log_ratios("probe").tobytes()
    # the shared parameters and the other apps' rows stay as they were
    assert torch.equal(scratch.params["cfg_gmf"], tp.params["cfg_gmf"])
    assert torch.equal(scratch.params["app_gmf"][:N_TRAIN], tp.params["app_gmf"])


def test_update_apps_matches_sequential(trained):
    tp = trained["tp"]
    jsurfs, japps, jsys = trained["jsurfs"], trained["japps"], trained["jsys"]
    sa = jprofiler.profile_app(jsurfs[japps[34].name], jsys, n_samples=8, seed=4)
    sb = jprofiler.profile_app(jsurfs[japps[35].name], jsys, n_samples=6, seed=5)
    seq = tp.infer_app("a", sa).infer_app("b", sb)
    bat = tp.update_apps({"a": sa, "b": sb})
    for n in ("a", "b"):
        np.testing.assert_allclose(seq.predict_log_ratios(n), bat.predict_log_ratios(n),
                                   rtol=0, atol=STACKED_TOL)


def test_seeded_draws_repeat_bitwise(trained):
    """Without injection the port draws from its own generators: two fits
    from one seed are bitwise equal, another seed differs, and an app's
    initial embedding depends only on its name."""
    tsys = trained["tsys"]
    obs = _observations(trained["jsys"], trained["jsurfs"], trained["japps"][:4])
    cfg = ncf.NCFConfig(**FAST)
    a = ncf.NCFPredictor.fit(tsys, obs, cfg, device=CPU)
    b = ncf.NCFPredictor.fit(tsys, obs, cfg, device=CPU)
    c = ncf.NCFPredictor.fit(tsys, obs, dataclasses.replace(cfg, seed=1), device=CPU)
    for x, y in zip(opt.tree_leaves(a.params), opt.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert not torch.equal(a.params["cfg_gmf"], c.params["cfg_gmf"])
    assert torch.equal(a._init_embedding("x")["gmf"], c._init_embedding("x")["gmf"])
    assert not torch.equal(a._init_embedding("x")["gmf"], a._init_embedding("y")["gmf"])


def test_fits_run_in_full_float32_whatever_the_process_setting(trained):
    """A fit and its predictions under a lowered process-wide float32
    matmul precision give the same bits as under full float32, and the
    process's setting is restored after each call."""
    obs = _observations(trained["jsys"], trained["jsurfs"], trained["japps"][:4])
    cfg = ncf.NCFConfig(**FAST)
    full = jprofiler.profile_app(trained["jsurfs"][trained["japps"][33].name],
                                 trained["jsys"], n_samples=8, seed=3)
    was = torch.get_float32_matmul_precision()
    runs = []
    try:
        for precision in ("highest", "medium"):
            torch.set_float32_matmul_precision(precision)
            p = ncf.NCFPredictor.fit(trained["tsys"], obs, cfg, device=CPU)
            q = p.infer_app("probe", full)
            assert torch.get_float32_matmul_precision() == precision
            runs.append((p, q.predict_log_ratios("probe")))
            assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(was)
    (a, pa), (b, pb) = runs
    for x, y in zip(opt.tree_leaves(a.params), opt.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert pa.tobytes() == pb.tobytes()


def test_allocator_onboards_and_allocates(trained):
    """The port's allocator end to end on carried weights: onboarding an
    unseen app matches the reference's prediction, and allocating on the
    predicted surfaces equals the reference's allocation."""
    jalloc, tp, tsys = trained["jalloc"], trained["tp"], trained["tsys"]
    talloc = EcoShiftAllocator(system=tsys, predictor=tp)
    jalloc = JAllocator(system=jalloc.system, predictor=jalloc.predictor)
    new = trained["japps"][36]
    jalloc.onboard(new.name, trained["jsurfs"][new.name], seed=2)
    talloc.onboard(new.name, trained["tsurfs"][new.name], seed=2)
    np.testing.assert_allclose(talloc.predicted[new.name].table,
                               jalloc.predicted[new.name].table, rtol=FIT_TOL, atol=0)
    name = trained["japps"][0].name
    jalloc.onboard_known(name)
    talloc.onboard_known(name)
    base = {name: (250.0, 150.0)}
    want = jalloc.allocate([trained["japps"][0]], base, 300.0)
    got = talloc.allocate([trained["tapps"][0]], base, 300.0)
    assert got.caps == want.caps
    for solver in ("pallas", "jax"):
        assert talloc.allocate([trained["tapps"][0]], base, 300.0, solver=solver).caps


# ---------------------------------------------------------------------------
# The online predictor
# ---------------------------------------------------------------------------


def _seeded(trained, names, **cfg):
    """(reference, port) online predictors seeded with identical tables:
    the reference's offline-predicted surfaces for ``names``."""
    jp = JOnline(trained["jp"], JOnlineCfg(**cfg))
    tp = OnlinePredictor(trained["tp"], OnlinePredictorConfig(**cfg))
    jseed = {n: trained["jalloc"].predicted[n] for n in names}
    jp.seed_surfaces(jseed)
    tp.seed_surfaces({
        n: surfaces.TabulatedSurface(cpu_levels=s.cpu_levels, gpu_levels=s.gpu_levels,
                                     table=np.array(s.table))
        for n, s in jseed.items()
    })
    return jp, tp


def _port_batch(b) -> TelemetryBatch:
    return TelemetryBatch(
        round=b.round, inst_gids=b.inst_gids.copy(), app_gids=b.app_gids.copy(),
        strings=list(b.strings), baseline_caps=b.baseline_caps.copy(),
        allocated_caps=b.allocated_caps.copy(), t_baseline=b.t_baseline.copy(),
        t_allocated=b.t_allocated.copy(), improvement=b.improvement.copy(),
    )


def _records(pkg_record, app):
    return [
        pkg_record(round=r, instance=inst, base_app=app, baseline_caps=(250.0, 150.0),
                   allocated_caps=(275.0, 200.0), t_baseline=t0, t_allocated=t1,
                   improvement=(t0 - t1) / t0 if t0 else 0.0)
        for r, inst, t0, t1 in (
            (0, "x#0", np.nan, 50.0), (0, "x#0", 60.0, -5.0),
            (1, "x#0", 60.0, 6e4), (2, "x#0", 60.0, 50.0),
            (2, "y#0", 60.0, 120.0), (3, "y#0", 0.0, 50.0),
        )
    ]


def _assert_state_equal(t, j):
    assert t._buffers == j._buffers
    assert t._app_of_instance == j._app_of_instance
    assert t._dirty == j._dirty
    assert (t.n_rejected, t.n_quarantine_dropped) == (j.n_rejected, j.n_quarantine_dropped)
    assert t._corrupt == j._corrupt
    assert t._quarantined_until == j._quarantined_until
    assert t.prediction_error == j.prediction_error


def test_ingest_matches_reference_bitwise(trained):
    """Buffers, pooled samples, the drift EMA and the rejection and
    quarantine counters from the same telemetry: a measured round, the
    same round with 40 % of its records corrupted, and garbage records."""
    names = [a.name for a in trained["japps"][:N_TRAIN]]
    jpred, tpred = _seeded(trained, names, quarantine_after=2, quarantine_rounds=2)
    jsim = JSim.build(trained["jsys"], trained["japps"][:N_TRAIN], trained["jsurfs"],
                      n_nodes=12, seed=0)
    jsim.run_round(j_make_controller("dps", trained["jsys"]), budget=900.0)
    clean = jsim.last_telemetry
    dirty = corrupt_batch(clean, TelemetryCorrupt(round=0, fraction=0.4, mode="nan", seed=7))
    for jb in (clean, dirty):
        jpred.observe(jb)
        tpred.observe(_port_batch(jb))
        _assert_state_equal(tpred, jpred)
    jpred.observe(_records(JRecord, names[0]))
    tpred.observe(_records(TelemetryRecord, names[0]))
    _assert_state_equal(tpred, jpred)
    assert tpred.n_rejected > 0 and tpred.n_quarantine_dropped > 0
    for app in names:
        assert tpred._pooled_samples(app) == jpred._pooled_samples(app)


def test_refresh_serves_surfaces_like_reference(trained):
    """With the drift threshold at 0 every dirty app refits: the same apps
    move, and the served tables agree within the fit tolerance."""
    names = [a.name for a in trained["japps"][:N_TRAIN]]
    jpred, tpred = _seeded(trained, names[:4], err_threshold=0.0, min_cells=2)
    jsim = JSim.build(trained["jsys"], trained["japps"][:N_TRAIN], trained["jsurfs"],
                      n_nodes=12, seed=0)
    jsim.run_round(j_make_controller("dps", trained["jsys"]), budget=900.0)
    jpred.observe(jsim.last_telemetry)
    tpred.observe(_port_batch(jsim.last_telemetry))
    changed = tpred.refresh()
    assert changed == jpred.refresh() and changed
    assert tpred.n_refits == jpred.n_refits
    for app in changed:
        np.testing.assert_allclose(tpred.surfaces[app].table, jpred.surfaces[app].table,
                                   rtol=FIT_TOL, atol=0)
    np.testing.assert_allclose(tpred.prior_surface().table, jpred.prior_surface().table,
                               rtol=FIT_TOL, atol=0)


def _warm_reference(trained, n_rounds=3):
    names = [a.name for a in trained["japps"][:N_TRAIN]]
    jpred, _ = _seeded(trained, names[:5])
    jsim = JSim.build(trained["jsys"], trained["japps"][:N_TRAIN], trained["jsurfs"],
                      n_nodes=10, seed=3)
    ctrl = j_make_controller("ecoshift_online", trained["jsys"], predictor=jpred)
    budgets = tuple(500.0 + 250.0 * r for r in range(n_rounds))
    jsim.run(JScenario(n_rounds, budget=budgets), ctrl)
    return jpred


def test_reference_state_dict_loads_and_round_trips(trained):
    jpred = _warm_reference(trained)
    state = jpred.state_dict()
    assert jpred.n_refits > 0 and state["buffers"]
    tpred = OnlinePredictor(trained["tp"])
    tpred.load_state_dict(state)
    _assert_state_equal(tpred, jpred)
    assert tpred.n_refits == jpred.n_refits and tpred.last_moves == jpred.last_moves
    for app, surf in jpred.surfaces.items():
        assert np.asarray(tpred.surfaces[app].table).tobytes() == \
            np.asarray(surf.table).tobytes()
    assert tpred.ncf.app_index == jpred.ncf.app_index
    assert _max_err(jpred.ncf.params, _np(tpred.ncf.params)) == 0.0
    # the port's own state dict round-trips bit for bit
    again = tpred.state_dict()
    assert again["buffers"] == state["buffers"]
    clone = OnlinePredictor(trained["tp"])
    clone.load_state_dict(again)
    _assert_state_equal(clone, tpred)
    for x, y in zip(opt.tree_leaves(clone.ncf.params), opt.tree_leaves(tpred.ncf.params)):
        assert torch.equal(x, y)
    clone.wipe()
    assert not clone._buffers and clone.n_refits == 0 and clone.ncf is trained["tp"]


# ---------------------------------------------------------------------------
# The online controller in the engine
# ---------------------------------------------------------------------------


def _online_runs(trained, jpred, tpred, scen_fn, solver, n_nodes=12):
    apps = slice(0, N_TRAIN)
    jsim = JSim.build(trained["jsys"], trained["japps"][apps], trained["jsurfs"],
                      n_nodes=n_nodes, seed=0)
    tsim = ClusterSim.build(trained["tsys"], trained["tapps"][apps], trained["tsurfs"],
                            n_nodes=n_nodes, seed=0, device=CPU)
    jc = j_make_controller("ecoshift_online", trained["jsys"], predictor=jpred,
                           solver=solver)
    tc = make_controller("ecoshift_online", trained["tsys"], predictor=tpred,
                         solver=solver, device=CPU)
    want = jsim.run(scen_fn(JScenario, jsim, trained["japps"]), jc)
    got = tsim.run(scen_fn(Scenario, tsim, trained["tapps"]), tc)
    return got, want


def _storm(scen_cls, sim, apps):
    _, recv, _ = sim.partition()
    return (
        scen_cls(4, budget=(500.0, 900.0, 700.0, 1100.0))
        .with_failure(1, recv[0].node_id)
        .with_straggler(2, recv[1].node_id, 1.8)
    )


@pytest.mark.parametrize("solver", ["sparse", "pallas"])
def test_online_controller_records_match_reference(trained, solver):
    """Fed the same served surfaces (every app seeded with identical
    tables, drift refits off), the online controller's records are the
    reference's bit for bit."""
    from test_torch_policies import assert_records_equal

    names = [a.name for a in trained["japps"][:N_TRAIN]]
    jpred, tpred = _seeded(trained, names, err_threshold=np.inf)
    got, want = _online_runs(trained, jpred, tpred, _storm, solver)
    assert tpred.n_refits == jpred.n_refits == 0
    assert_records_equal(got, want, n_rounds=4)


def _tables_after_refresh(pred):
    """Record the served tables after every refresh."""
    trace = []
    refresh = pred.refresh

    def wrapped():
        changed = refresh()
        trace.append({a: np.array(s.table) for a, s in pred.surfaces.items()})
        return changed

    pred.refresh = wrapped
    return trace


def test_online_loop_with_cold_arrival_matches_reference(trained):
    """A held-out app arrives cold at round 1: it is served the prior, then
    its telemetry fit.  Per round the served surfaces agree within the fit
    tolerance and the measured average improvement within 1e-6."""
    names = [a.name for a in trained["japps"][:N_TRAIN]]
    jpred, tpred = _seeded(trained, names)
    jtrace, ttrace = _tables_after_refresh(jpred), _tables_after_refresh(tpred)
    cold = {"jax": trained["japps"][37], "torch": trained["tapps"][37]}

    def scen(scen_cls, sim, apps):
        c = cold["jax" if scen_cls is JScenario else "torch"]
        budgets = tuple(600.0 + 300.0 * ((3 * r) % 4) for r in range(5))
        return scen_cls(5, budget=budgets).with_arrival(1, c)

    got, want = _online_runs(trained, jpred, tpred, scen, "sparse")
    cname = cold["torch"].name
    assert not tpred.is_cold(cname) and tpred.n_refits == jpred.n_refits > 0
    assert len(ttrace) == len(jtrace) == 5
    for t_tables, j_tables in zip(ttrace, jtrace):
        assert t_tables.keys() == j_tables.keys()
        for app in j_tables:
            np.testing.assert_allclose(t_tables[app], j_tables[app], rtol=FIT_TOL, atol=0)
    for g, w in zip(got.records, want.records):
        assert abs(g.result.avg_improvement - w.result.avg_improvement) <= 1e-6
        assert g.result.allocation.spent <= g.result.budget + 1e-9
    inst = f"{cname}#n12"
    imp = got.improvements_of(inst)
    assert np.isnan(imp[0]) and np.isfinite(imp[1:]).all()


def test_online_batch_carries_no_true_surface(trained):
    """The engine hands ``ecoshift_online`` batches with no surface filled
    in, cached under their own mode beside the true-surface batches."""
    names = [a.name for a in trained["japps"][:N_TRAIN]]
    _, tpred = _seeded(trained, names, err_threshold=np.inf)
    sim = ClusterSim.build(trained["tsys"], trained["tapps"][:N_TRAIN], trained["tsurfs"],
                           n_nodes=12, seed=0, device=CPU)
    ctrl = make_controller("ecoshift_online", trained["tsys"], predictor=tpred, device=CPU)
    seen = []
    inner = ctrl.allocate_grouped

    def spy(batch, budget):
        seen.append(batch)
        return inner(batch, budget)

    ctrl.allocate_grouped = spy
    sim.run(Scenario.constant(3, 600.0), ctrl)
    assert len(seen) == 3 and all(s is None for b in seen for s in b.surfaces)
    assert seen[1] is seen[0] and seen[2] is seen[0]  # event-free: the cached batch
    rows = sim.partition_rows()[1]
    true_batch = sim._receiver_batch(rows, None, True)
    assert all(s is not None for s in true_batch.surfaces)
    assert sim._receiver_batch(rows, None, False, skip_surfaces=True) is not true_batch


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fit_on_card_repeats_bitwise_and_matches_host(cuda, trained):
    """Two card fits from one seed give the same bits (the one-hot
    lookups' backward is a matmul, not a scatter-add), also with TF32
    allowed in the process, and the card's fit stays within the fit
    tolerance of the host's on the same streams."""
    obs = _observations(trained["jsys"], trained["jsurfs"], trained["japps"][:6])
    cfg = ncf.NCFConfig(**FAST)
    a = ncf.NCFPredictor.fit(trained["tsys"], obs, cfg, device=cuda)
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        b = ncf.NCFPredictor.fit(trained["tsys"], obs, cfg, device=cuda)
    finally:
        torch.set_float32_matmul_precision(was)
    h = ncf.NCFPredictor.fit(trained["tsys"], obs, cfg, device=CPU)
    for x, y, z in zip(*(opt.tree_leaves(p.params) for p in (a, b, h))):
        assert torch.equal(x, y)
        assert float((x.cpu() - z).abs().max()) <= FIT_TOL
    full = jprofiler.profile_app(trained["jsurfs"][trained["japps"][33].name],
                                 trained["jsys"], n_samples=8, seed=3)
    scratch = a.infer_app("probe", full)
    incremental = a.infer_app("probe", dict(list(full.items())[:4])).update_app("probe", full)
    assert scratch.predict_log_ratios("probe").tobytes() == \
        incremental.predict_log_ratios("probe").tobytes()


@pytest.mark.gpu
def test_online_loop_on_card_kernel_equals_plain(cuda, trained):
    """``ecoshift_online`` on the card with a cold arrival: the dense
    (max,+) kernel's records equal the plain version's bit for bit, and the
    kernel ran once a DP stage."""
    from repro_torch.kernels import mckp_dp

    names = [a.name for a in trained["japps"][:N_TRAIN]]
    tp = dataclasses.replace(trained["tp"], device=cuda)
    runs = {}
    for solver in ("pallas", "jax"):
        _, pred = _seeded(dict(trained, tp=tp), names)
        sim = ClusterSim.build(trained["tsys"], trained["tapps"][:N_TRAIN],
                               trained["tsurfs"], n_nodes=12, seed=0, device=cuda)
        ctrl = make_controller("ecoshift_online", trained["tsys"], predictor=pred,
                               solver=solver, device=cuda)
        scen = Scenario(4, budget=(600.0, 1200.0, 900.0, 600.0)).with_arrival(
            1, trained["tapps"][37])
        mckp_dp.reset_launches()
        runs[solver] = sim.run(scen, ctrl)
        if solver == "pallas":
            stages = sum(len(r.result.improvements) for r in runs[solver].records)
            assert mckp_dp.launches["maxplus_conv_batched"] == stages
        assert pred.n_refits > 0
    from test_torch_policies import assert_records_equal

    assert_records_equal(runs["pallas"], runs["jax"], n_rounds=4)
