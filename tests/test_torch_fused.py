"""The port's flat fused device round and its sparse-option (max,+) stage
against the JAX package, bit for bit.

* The stage's plain PyTorch version (``repro_torch.kernels.ref``) is held
  against the Pallas kernel ``maxplus_stage_pallas_batched`` run in
  interpret mode, in float64 (inside ``jax.enable_x64(True)``, scoped) and
  in float32.  The stage only adds and compares, so the tolerance is zero:
  outputs compare as raw bits.
* The fused round (``device="cpu"``: its stage takes the plain version) is
  held against the JAX package's **host** sparse solver, because the
  reference's fused path needs an API this jax version removed; the
  reference certifies fused == host bit for bit.  Tolerance zero.
* ``gpu``-marked tests hold the CUDA kernel against its plain version and
  the fused round on the card against the host solver; they skip without
  a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ClusterSim as JSim
from repro.cluster import Scenario as JScenario
from repro.cluster.controller import make_controller as j_make_controller
from repro.core import curves as jcurves
from repro.core import mckp as jmckp
from repro.core import surfaces as jsurfaces
from repro.core import types as jtypes
from repro.kernels import mckp_dp as jmk
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.cluster import ClusterSim, Scenario
from repro_torch.cluster.controller import make_controller
from repro_torch.core import mckp, surfaces, types
from repro_torch.kernels import mckp_dp, ops, ref
from test_torch_sparse import run_storm_pair

# the shapes here are tiny: one intra-op thread keeps this file from
# crowding the other test workers' cores
torch.set_num_threads(1)
CPU = "cpu"
DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


def _stage_inputs(rows: int, nb: int, k: int, np_dtype, seed: int):
    """dp [rows, nb] on a 1/4 lattice (exact ties) with -inf holes and one
    all -inf row; kb [rows, k] descending in [0, nb] (so kb > b occurs);
    vb [rows, k] with -inf padded option tails."""
    rng = np.random.default_rng(seed)
    dp = np.round(rng.uniform(0, 20, (rows, nb)) * 4) / 4
    dp[rng.random((rows, nb)) < 0.2] = -np.inf
    if rows > 1:
        dp[1] = -np.inf
    kb = np.sort(rng.integers(0, nb + 1, (rows, k)), axis=1)[:, ::-1].astype(np.int32)
    kb[:, 0] = nb
    vb = np.round(rng.uniform(0, 3, (rows, k)) * 4) / 4
    vb[:, k - max(1, k // 5) :] = -np.inf
    kb[:, k - max(1, k // 5) :] = 0
    return dp.astype(np_dtype), kb.copy(), vb.astype(np_dtype)


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rows, nb, k", [(1, 64, 8), (3, 300, 37), (2, 513, 130)])
def test_stage_plain_matches_pallas_interpret(dtype, rows, nb, k):
    np_dtype, t_dtype = DTYPES[dtype]
    dp, kb, vb = _stage_inputs(rows, nb, k, np_dtype, seed=rows * nb + k)
    got_out, got_arg = ref.maxplus_stage_batched(
        torch.from_numpy(dp), torch.from_numpy(kb), torch.from_numpy(vb)
    )
    with jax.enable_x64(dtype == "float64"):
        want_out, want_arg = jmk.maxplus_stage_pallas_batched(
            jnp.asarray(dp), jnp.asarray(kb), jnp.asarray(vb), interpret=True
        )
        want_out, want_arg = np.asarray(want_out), np.asarray(want_arg)
    assert got_out.dtype == t_dtype
    _assert_bits(got_out.numpy(), want_out)
    _assert_bits(got_arg.numpy(), want_arg)
    # and the CPU route of the public wrapper is the plain version
    out, arg = ops.maxplus_stage_batched(
        torch.from_numpy(dp), torch.from_numpy(kb), torch.from_numpy(vb)
    )
    _assert_bits(out.numpy(), want_out)
    _assert_bits(arg.numpy(), want_arg)


def test_stage_plain_keeps_first_maximizer():
    """Ties keep the first j (argmax over j returns the first maximal
    index), an all -inf column gives arg 0, and kb > b reads -inf."""
    dp = torch.tensor([[0.0, 1.0, 1.0, 2.0], [-torch.inf] * 4], dtype=torch.float64)
    kb = torch.tensor([[2, 1, 0, 9], [1, 0, 0, 0]], dtype=torch.int32)
    vb = torch.tensor([[1.0, 1.0, 0.0, 5.0], [1.0, 2.0, 2.0, -torch.inf]], dtype=torch.float64)
    out, arg = ref.maxplus_stage_batched(dp, kb, vb)
    # b=0: only j=2 in range (0+0); b=1: j=1 -> 0+1=1 ties j=2 -> 1+0=1: first is 1
    # b=2: j=0 -> 0+1, j=1 -> 1+1=2, j=2 -> 1+0: j=1; b=3: j=0 2, j=1 2, j=2 2: j=0
    assert out[0].tolist() == [0.0, 1.0, 2.0, 2.0]
    assert arg[0].tolist() == [2, 1, 1, 0]
    assert out[1].tolist() == [-np.inf] * 4 and arg[1].tolist() == [0] * 4


def test_stage_cpu_route_counts_nothing_and_kernel_guards():
    mckp_dp.reset_launches()
    dp, kb, vb = (torch.from_numpy(a) for a in _stage_inputs(2, 40, 5, np.float64, 1))
    ops.maxplus_stage_batched(dp, kb, vb)
    assert mckp_dp.launches["maxplus_stage_batched"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        mckp_dp.maxplus_stage_batched(dp, kb, vb)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.maxplus_stage_batched(dp, kb[:, :3], vb)
    with pytest.raises(TypeError, match="dp's type"):
        ops.maxplus_stage_batched(dp, kb, vb.float())
    src = mckp_dp.SOURCES["maxplus_stage"].read_text()
    assert "maxplus_stage_pallas_batched" in src and "mckp_dp.py:126" in src
    assert mckp_dp.library_path("maxplus_stage").parent == mckp_dp.BUILD_DIR


def test_bank_compact_matches_reference():
    rng = np.random.default_rng(4)
    s_old, l_old, k_old = 4, 3, 8
    kb = rng.integers(0, 50, (s_old, l_old, k_old)).astype(np.int32)
    vb = rng.uniform(0, 1, (s_old, l_old, k_old))
    vb[..., 6:] = -np.inf
    src_s = rng.integers(-1, s_old, (6, 2)).astype(np.int32)
    src_l = rng.integers(0, l_old, (6, 2)).astype(np.int32)
    for k_pad in (4, 8, 16):
        got = ops.bank_compact(
            torch.from_numpy(kb), torch.from_numpy(vb),
            torch.from_numpy(src_s), torch.from_numpy(src_l), k_pad=k_pad,
        )
        with jax.enable_x64(True):
            want = jops.bank_compact(
                jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(src_s),
                jnp.asarray(src_l), k_pad=k_pad,
            )
            want = [np.asarray(w) for w in want]
        for g, w in zip(got, want):
            _assert_bits(g.numpy(), w)


# ---------------------------------------------------------------------------
# The flat fused round against the reference host solver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    return (
        jsurfaces.build_paper_suite(jtypes.SYSTEM_1),
        surfaces.build_paper_suite(types.SYSTEM_1),
    )


@pytest.mark.parametrize("churn", [0.0, 0.01, 0.10])
@pytest.mark.parametrize("seed", range(3))
def test_fused_flat_parity(suites, churn, seed):
    """tests/test_incremental_alloc.py's flat sequences: the port's fused
    controller against the reference's host incremental controller under
    a churn-scaled event storm, bit for bit every round."""
    ctrl, solvers = run_storm_pair(suites, seed, churn, {"fused": True})
    stats = ctrl.fused_stats()
    assert stats.attempts > 0
    assert stats.fallbacks == 0
    assert stats.rebuilds == 1  # cold start only
    # every round the reference solved ran fused here; cache hits agree
    assert [g for g, _ in solvers] == [
        "fused" if w == "host" else w for _, w in solvers
    ]


def _toy_groups(n_classes, *, k=3, prefix="cls", cost0=25.0):
    """tests/test_incremental_alloc.py's lattice-friendly classes, as
    (reference groups, port groups)."""
    jg = []
    for g in range(n_classes):
        costs = cost0 * np.arange(1, k + 1) + 25.0 * g
        values = np.linspace(0.05, 0.4, k) + 0.01 * g
        caps = np.stack([100.0 + costs, np.full(k, 100.0)], axis=-1)
        table = jcurves.OptionTable(
            name=f"{prefix}{g}",
            costs=np.concatenate([[0.0], costs]),
            values=np.concatenate([[0.0], values]),
            caps=np.concatenate([[[100.0, 100.0]], caps], axis=0),
        )
        jg.append(jmckp.GroupedOptions(table=table, members=(f"{prefix}{g}n0",)))
    return jg, interop.grouped_options_from_arrays(
        [(g.table.name, g.table.costs, g.table.values, g.table.caps, g.members)
         for g in jg]
    )


def _fused_vs_host(pair, budget, fstate):
    jg, tg = pair
    sol = mckp.solve_grouped_fused(tg, budget, fstate=fstate, device=CPU)
    assert sol is not None
    want = jmckp.solve_sparse_grouped(jg, budget)
    assert sol.picks == want.picks
    assert sol.spent == want.spent and sol.total_value == want.total_value
    return sol


def test_fused_compaction_on_slack_exhaustion():
    fstate = mckp.FusedState()
    _fused_vs_host(_toy_groups(2), 900.0, fstate)
    assert fstate.stats["rebuilds"] == 1
    assert fstate.stats["compactions"] == 0
    # 2 classes fit the s_pad=8 tier; 11 classes exhaust it -> repack
    _fused_vs_host(_toy_groups(11), 900.0, fstate)
    assert fstate.stats["rebuilds"] == 1
    assert fstate.stats["compactions"] == 1
    assert fstate.stats["fallbacks"] == 0
    # shrinking back stays under the sticky tier: delta patch, no compaction
    _fused_vs_host(_toy_groups(3), 900.0, fstate)
    assert fstate.stats["compactions"] == 1
    assert fstate.stats["fallbacks"] == 0
    assert 0.0 < fstate.stats["slack_utilization"] <= 1.0


def test_fused_off_lattice_fallback_and_resume():
    fstate = mckp.FusedState()
    good = _toy_groups(2)
    _fused_vs_host(good, 900.0, fstate)
    n0 = fstate.stats["fallbacks"]
    bad_cost = 175111078930.00565  # fails the micro-watt round trip
    _, tbad = _toy_groups(1, prefix="bad", cost0=bad_cost)
    sol = mckp.solve_grouped_fused(good[1] + tbad, 2.0 * bad_cost, fstate=fstate, device=CPU)
    assert sol is None
    assert fstate.stats["fallback_reason"] == "off_lattice"
    assert fstate.stats["fallbacks"] == n0 + 1
    _fused_vs_host(good, 900.0, fstate)
    assert fstate.stats["fallback_reason"] == ""
    assert fstate.stats["fallbacks"] == n0 + 1


def test_fused_grid_overflow_fallback_and_resume():
    fstate = mckp.FusedState()
    good = _toy_groups(2)
    _fused_vs_host(good, 900.0, fstate)
    n0 = fstate.stats["fallbacks"]
    costs = np.array([25.0, 25.000001])  # gcd pitch: 1 micro-watt
    caps = np.concatenate(
        [[[100.0, 100.0]], np.stack([100.0 + costs, 100.0 + 0 * costs], axis=-1)]
    )
    bad = interop.grouped_options_from_arrays(
        [("dense", np.concatenate([[0.0], costs]), np.array([0.0, 0.1, 0.2]), caps,
          ("densen0",))]
    )
    assert mckp.solve_grouped_fused(bad, 100.0, fstate=fstate, device=CPU) is None
    assert fstate.stats["fallback_reason"] == "grid_overflow"
    assert fstate.stats["fallbacks"] == n0 + 1
    _fused_vs_host(good, 900.0, fstate)
    assert fstate.stats["fallback_reason"] == ""
    assert fstate.stats["fallbacks"] == n0 + 1


def test_fused_short_circuit_and_segments():
    fstate = mckp.FusedState()
    pair = _toy_groups(3)
    a = _fused_vs_host(pair, 600.0, fstate)
    b = _fused_vs_host(pair, 600.0, fstate)
    assert b is a and fstate.stats["short_circuits"] == 1
    assert set(fstate.last_segments) == {
        "prep_s", "patch_s", "compact_s", "dispatch_s", "backtrack_s", "assembly_s"
    }
    assert fstate.stats["rounds"] == 2 and fstate.stats["device_s"] > 0.0
    for kind in ("tree", "leaf_root", "flat"):
        assert mckp._fused_run([], kind, None, (), pick_cache=None,
                               fstate=fstate, device=torch.device(CPU)) is None
        assert fstate.stats["fallback_reason"] == "empty"
    # no receivers at all is one leaf with no stages: an empty solution
    sol = mckp.solve_grouped_fused([], 10.0, fstate=fstate, device=CPU)
    assert sol is not None and sol.picks == {} and sol.spent == 0.0


def test_fused_stats_fields_match_reference():
    assert [f.name for f in dataclasses.fields(types.FusedRoundStats)] == [
        f.name for f in dataclasses.fields(jtypes.FusedRoundStats)
    ]
    assert types.FUSED_FALLBACK_REASONS == jtypes.FUSED_FALLBACK_REASONS


# ---------------------------------------------------------------------------
# The whole slice through ClusterSim.run: 64 nodes, 4 rounds
# ---------------------------------------------------------------------------

N_NODES, N_ROUNDS = 64, 4


def _recording(ctrl, pads=None):
    """Wrap a controller's allocate_grouped to log last_solver per round
    (and, into ``pads``, the padded stage count of each fused round)."""
    log = []
    inner = ctrl.allocate_grouped

    def allocate_grouped(batch, budget):
        alloc = inner(batch, budget)
        log.append(ctrl.last_solver)
        if pads is not None and ctrl.last_solver == "fused":
            pads.append(ctrl._fused_state.kb_dev.shape[0])
        return alloc

    ctrl.allocate_grouped = allocate_grouped
    return log


def _scenario(scen_cls, recv):
    return (
        scen_cls.constant(N_ROUNDS)
        .with_failure(1, recv[0].node_id)
        .with_straggler(2, recv[1].node_id, 1.8)
    )


def _port_sim_run(apps, surfs, device, pads=None, **kw):
    sim = ClusterSim.build(types.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0, device=device)
    _, recv, _ = sim.partition()
    ctrl = make_controller("ecoshift", types.SYSTEM_2, device=device, **kw)
    log = _recording(ctrl, pads)
    return sim.run(_scenario(Scenario, recv), ctrl), log, ctrl


def _assert_records_equal(got, want):
    assert len(got.records) == len(want.records) == N_ROUNDS
    for g, w in zip(got.records, want.records):
        ga, wa = g.result.allocation, w.result.allocation
        assert dict(ga.caps) == dict(wa.caps)
        assert ga.spent == wa.spent
        assert ga.predicted_improvement == wa.predicted_improvement
        assert g.result.improvements == w.result.improvements
        assert (g.pool, g.n_alive, g.result.budget) == (w.pool, w.n_alive, w.result.budget)
        assert ga.spent <= g.result.budget + 1e-9
        for col in ("allocated_caps", "t_baseline", "t_allocated", "improvement"):
            assert getattr(g.telemetry, col).tobytes() == getattr(w.telemetry, col).tobytes()


@pytest.fixture(scope="module")
def reference_run():
    apps, surfs = jsurfaces.build_paper_suite(jtypes.SYSTEM_2)
    sim = JSim.build(jtypes.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0)
    _, recv, _ = sim.partition()
    ctrl = j_make_controller("ecoshift", jtypes.SYSTEM_2)
    log = _recording(ctrl)
    return sim.run(_scenario(JScenario, recv), ctrl), log


@pytest.mark.parametrize("fused", [False, True])
def test_sim_run_matches_reference(reference_run, fused):
    want, want_log = reference_run
    apps, surfs = surfaces.build_paper_suite(types.SYSTEM_2)
    got, log, ctrl = _port_sim_run(apps, surfs, CPU, fused=fused)
    _assert_records_equal(got, want)
    assert [("host" if s == "fused" else s) for s in log] == want_log
    if fused:
        assert "fused" in log and "host" not in log
        assert ctrl.fused_stats().fallbacks == 0
    # the policy name alone runs the sparse default on the sim's device
    sim = ClusterSim.build(types.SYSTEM_2, apps, surfs, n_nodes=N_NODES, seed=0, device=CPU)
    _, recv, _ = sim.partition()
    _assert_records_equal(sim.run(_scenario(Scenario, recv), "ecoshift"), want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(
    "rows, nb, k", [(1, 4096, 1024), (1, 512, 128), (3, 1037, 37), (2, 129, 300)]
)
def test_stage_kernel_matches_plain_on_card(cuda, dtype, rows, nb, k):
    np_dtype, _ = DTYPES[dtype]
    dp, kb, vb = (
        torch.from_numpy(a).to(cuda) for a in _stage_inputs(rows, nb, k, np_dtype, nb + k)
    )
    mckp_dp.reset_launches()
    out, arg = mckp_dp.maxplus_stage_batched(dp, kb, vb)
    torch.cuda.synchronize()
    assert mckp_dp.launches["maxplus_stage_batched"] == 1
    want_out, want_arg = ref.maxplus_stage_batched(dp, kb, vb)
    _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
    _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())


@pytest.mark.gpu
def test_fused_round_on_card_matches_reference(cuda, reference_run):
    want, want_log = reference_run
    apps, surfs = surfaces.build_paper_suite(types.SYSTEM_2)
    mckp_dp.reset_launches()
    pads = []
    got, log, ctrl = _port_sim_run(apps, surfs, cuda, pads, fused=True)
    _assert_records_equal(got, want)
    assert [("host" if s == "fused" else s) for s in log] == want_log
    assert ctrl.fused_stats().fallbacks == 0
    # one multi-stage launch per fused round, no single-stage launch
    assert mckp_dp.launches["maxplus_stages_batched"] == len(pads) > 0
    assert mckp_dp.launches["maxplus_stage_batched"] == 0
