"""The multi-stage sparse-option (max,+) kernel of the fused round's leaf
scan and its single-stage entry, against the JAX package, bit for bit.

* A plain numpy model of the kernel's decomposition — work items of one
  row and one 32-wide b-group, the group's options split into strided
  j-subsets (one a warp) each scanned in ascending order with a strict
  ``>`` from (-inf, first j), off-row reads as -inf, and the butterfly
  merge of the partials by the lexicographic rule (larger value; on
  ``==`` the smaller j, with its value) — is held against the plain version
  (``repro_torch.kernels.ref``) and the Pallas kernel
  ``maxplus_stage_pallas_batched`` in interpret mode: float64 inside
  ``jax.enable_x64(True)`` (scoped) and float32.  Inputs hold all -inf
  rows, tied +-0 columns, -inf option tails, kb = NB and kb > b.
* The plain multi-stage function is held against a loop of the Pallas
  stage and the ``jnp.where`` feasibility mask: the JAX ``leaf_scan``'s
  body.  The fused round's leaf scan on the CPU is held against the loop it
  replaced.
* ``gpu``-marked tests hold the CUDA kernel against its plain version at
  the fused main path's shape, ragged multi-row shapes, an NB too large for
  shared memory, and under CUDA-graph capture; they skip without a card.

The stages only add and compare, so every tolerance is zero: outputs
compare as raw bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mckp_dp as jmk
from repro_torch.core import mckp
from repro_torch.kernels import mckp_dp, ops, ref

torch.set_num_threads(1)
DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}
# the kernel's own constant (csrc/maxplus_stage.cu): warps a block = j-subsets
WARPS = 32


def _inputs(stages: int, rows: int, nb: int, k: int, np_dtype, seed: int):
    """dp0 [rows, nb]: a 1/4 lattice (exact ties) with -inf holes; row 1 all
    -inf; row 2 all +-0 (tied signed zeros).  kb [stages, rows, k] int32
    descending in [0, nb] with kb[..., 0] = nb (so kb > b occurs); vb with
    -inf padded option tails (kb = 0 there), and +-0 options in row 2."""
    rng = np.random.default_rng(seed)
    dp = np.round(rng.uniform(0, 20, (rows, nb)) * 4) / 4
    dp[rng.random((rows, nb)) < 0.2] = -np.inf
    if rows > 1:
        dp[1] = -np.inf
    if rows > 2:
        dp[2] = np.where(rng.random(nb) < 0.5, -0.0, 0.0)
    kb = np.sort(rng.integers(0, nb + 1, (stages, rows, k)), axis=2)[..., ::-1].astype(np.int32)
    kb[..., 0] = nb
    vb = np.round(rng.uniform(0, 3, (stages, rows, k)) * 4) / 4
    if rows > 2:
        vb[:, 2] = np.where(rng.random((stages, k)) < 0.5, -0.0, 0.0)
    tail = max(1, k // 5)
    vb[..., k - tail :] = -np.inf
    kb[..., k - tail :] = 0
    return dp.astype(np_dtype), kb.copy(), vb.astype(np_dtype)


def _decomposed_stage(dp, kb, vb, warps: int = WARPS):
    """The kernel's decomposition of one stage, in numpy: dp [R, NB], kb, vb
    [R, K] -> (out, arg).  ``warps`` is a power of two."""
    rows, nb = dp.shape
    k = kb.shape[1]
    neg = np.array(-np.inf, dp.dtype)
    out = np.empty_like(dp)
    arg = np.empty((rows, nb), np.int32)
    for r in range(rows):
        for g in range(-(-nb // 32)):  # one work item
            b = 32 * g + np.arange(32)
            pv = np.full((warps, 32), neg)
            pa = np.repeat(np.arange(warps, dtype=np.int32)[:, None], 32, axis=1)
            for w in range(warps):
                for j in range(w, k, warps):  # ascending, strict >
                    idx = b - int(kb[r, j])
                    on_row = (idx >= 0) & (idx < nb)
                    cand = np.where(on_row, dp[r, np.clip(idx, 0, nb - 1)], neg) + vb[r, j]
                    better = cand > pv[w]
                    pv[w] = np.where(better, cand, pv[w])
                    pa[w] = np.where(better, np.int32(j), pa[w])
            off = warps // 2
            while off:  # butterfly merge, the lexicographic rule
                v2, a2 = pv[np.arange(warps) ^ off], pa[np.arange(warps) ^ off]
                take = (v2 > pv) | ((v2 == pv) & (a2 < pa))
                pv, pa = np.where(take, v2, pv), np.where(take, a2, pa)
                off //= 2
            assert (pv == pv[0]).all() and (pa == pa[0]).all()
            valid = b < nb
            out[r, b[valid]] = pv[0][valid]
            arg[r, b[valid]] = pa[0][valid]
    return out, arg


def _decomposed_stages(dp0, kb, vb, tmax, warps: int = WARPS):
    """The multi-stage launch in numpy: the decomposed stage S times, each
    out masked to -inf where b > tmax[r]."""
    over = np.arange(dp0.shape[1])[None, :] > tmax[:, None]
    dp, wins = dp0, []
    for s in range(kb.shape[0]):
        out, arg = _decomposed_stage(dp, kb[s], vb[s], warps)
        dp = np.where(over, np.array(-np.inf, dp0.dtype), out)
        wins.append(arg)
    return dp, np.stack(wins)


def _pallas_stage(dp, kb, vb, dtype: str):
    with jax.enable_x64(dtype == "float64"):
        out, arg = jmk.maxplus_stage_pallas_batched(
            jnp.asarray(dp), jnp.asarray(kb), jnp.asarray(vb), interpret=True
        )
        return np.asarray(out), np.asarray(arg)


def _pallas_leaf_scan(dp0, kb, vb, tmax, dtype: str):
    """The JAX leaf_scan's body (src/repro/core/mckp.py:1912-1927) as a
    loop: the Pallas stage in interpret mode, then the feasibility mask."""
    with jax.enable_x64(dtype == "float64"):
        t_idx = jnp.arange(dp0.shape[1])
        tm = jnp.asarray(tmax)
        dp, wins = jnp.asarray(dp0), []
        neg = jnp.asarray(-jnp.inf, dp.dtype)
        for s in range(kb.shape[0]):
            out, arg = jmk.maxplus_stage_pallas_batched(
                dp, jnp.asarray(kb[s]), jnp.asarray(vb[s]), interpret=True
            )
            dp = jnp.where(t_idx[None, :] > tm[:, None], neg, out)
            wins.append(np.asarray(arg))
        return np.asarray(dp), np.stack(wins)


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(
    "rows, nb, k, warps",
    [
        (3, 300, 37, WARPS),  # the kernel's warps, ragged NB, subsets of 1-2
        (3, 513, 130, WARPS),  # kb = NB, -inf tails
        (4, 1037, 61, 8),  # longer subsets
        (3, 64, 9, 2),
    ],
)
def test_decomposition_matches_plain_and_pallas(dtype, rows, nb, k, warps):
    np_dtype, _ = DTYPES[dtype]
    dp, kb, vb = _inputs(1, rows, nb, k, np_dtype, seed=nb + k)
    kb, vb = kb[0], vb[0]
    got_out, got_arg = _decomposed_stage(dp, kb, vb, warps)
    want_out, want_arg = _pallas_stage(dp, kb, vb, dtype)
    _assert_bits(got_out, want_out)
    _assert_bits(got_arg, want_arg)
    out, arg = ref.maxplus_stage_batched(
        torch.from_numpy(dp), torch.from_numpy(kb), torch.from_numpy(vb)
    )
    _assert_bits(out.numpy(), want_out)
    _assert_bits(arg.numpy(), want_arg)
    # the +-0 row keeps the first maximizer's sign, the -inf row arg 0
    zeros = want_out[2][want_out[2] == 0]
    assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    assert (want_arg[1] == 0).all() and np.isneginf(want_out[1]).all()


def test_merge_rule_is_order_free_and_keeps_the_first_zero():
    """Larger value first; on == (so -0.0 ties +0.0) the smaller j and its
    value: any merge order of the partials gives the serial scan's pair."""
    parts = [(0.0, 5), (-0.0, 2), (-np.inf, 0), (0.0, 9), (-np.inf, 3)]

    def merge(ps):
        bv, ba = ps[0]
        for v, a in ps[1:]:
            if v > bv or (v == bv and a < ba):
                bv, ba = v, a
        return bv, ba

    rng = np.random.default_rng(0)
    for _ in range(20):
        v, a = merge([parts[i] for i in rng.permutation(len(parts))])
        assert a == 2 and v == 0.0 and np.signbit(v)
    assert merge([(-np.inf, 3), (-np.inf, 0)]) == (-np.inf, 0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_stages_match_pallas_leaf_scan(dtype):
    """S = 8 stages over L = 3 rows: the plain multi-stage function, the
    public wrapper's CPU route and the decomposition model against the
    Pallas stage loop with the mask; tmax cuts inside, beyond and before
    the row."""
    np_dtype, t_dtype = DTYPES[dtype]
    nb, k = 260, 24
    _, kb, vb = _inputs(8, 3, nb, k, np_dtype, seed=7)
    kb //= 8  # spends that 8 stages can sum inside the row
    dp0 = np.full((3, nb), -np.inf, np_dtype)
    dp0[:, 0] = 0.0
    tmax = np.array([200, nb + 5, 131], np.int32)
    want_dp, want_wins = _pallas_leaf_scan(dp0, kb, vb, tmax, dtype)
    args = [torch.from_numpy(a) for a in (dp0, kb, vb, tmax)]
    for fn in (ref.maxplus_stages_batched, ops.maxplus_stages_batched):
        dp, wins = fn(*args)
        assert dp.dtype == t_dtype and wins.dtype == torch.int32
        _assert_bits(dp.numpy(), want_dp)
        _assert_bits(wins.numpy(), want_wins)
    got_dp, got_wins = _decomposed_stages(dp0, kb, vb, tmax, warps=8)
    _assert_bits(got_dp, want_dp)
    _assert_bits(got_wins, want_wins)
    assert np.isneginf(want_dp[0, 201:]).all() and np.isfinite(want_dp[1]).any()
    # no mask: each stage's out feeds the next as it is
    dp, wins = ref.maxplus_stages_batched(*args[:3])
    d = torch.from_numpy(dp0)
    for s in range(8):
        d, arg = ref.maxplus_stage_batched(d, args[1][s], args[2][s])
        _assert_bits(wins[s].numpy(), arg.numpy())
    _assert_bits(dp.numpy(), d.numpy())


def test_fused_leaf_scan_on_cpu_unchanged():
    """_fused_leaf_scan now makes one multi-stage call; on the CPU it is
    bitwise the per-stage loop, mask and stack it replaced."""
    nb, k = 300, 40
    _, kb, vb = _inputs(6, 2, nb, k, np.float64, seed=11)
    kb //= 6
    kb, vb = torch.from_numpy(kb), torch.from_numpy(vb)
    tmax = torch.tensor([250, 120], dtype=torch.int32)
    dp, wins = mckp._fused_leaf_scan(kb, vb, tmax, nb)
    want = torch.full((2, nb), -torch.inf, dtype=torch.float64)
    want[:, 0] = 0.0
    over = torch.arange(nb)[None, :] > tmax[:, None]
    args = []
    for s in range(kb.shape[0]):
        out, arg = ref.maxplus_stage_batched(want, kb[s], vb[s])
        want = torch.where(over, -torch.inf, out)
        args.append(arg)
    assert torch.isfinite(want).any(1).all()
    _assert_bits(dp.numpy(), want.numpy())
    _assert_bits(wins.numpy(), torch.stack(args).numpy())


def test_stages_cpu_route_counts_nothing_and_kernel_guards():
    mckp_dp.reset_launches()
    dp, kb, vb = (torch.from_numpy(a) for a in _inputs(3, 2, 40, 5, np.float64, 1))
    tmax = torch.tensor([30, 50], dtype=torch.int32)
    ops.maxplus_stages_batched(dp, kb, vb, tmax)
    assert mckp_dp.launches["maxplus_stages_batched"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        mckp_dp.maxplus_stages_batched(dp, kb, vb, tmax)
    with pytest.raises(ValueError, match="bad shapes"):
        mckp_dp.maxplus_stages_batched(dp, kb[:, :1], vb, tmax)
    with pytest.raises(ValueError, match="bad shapes"):
        mckp_dp.maxplus_stages_batched(dp, kb, vb, tmax[:1])
    with pytest.raises(ValueError, match="bad shapes"):
        ops.maxplus_stages_batched(dp, kb[0], vb[0])
    with pytest.raises(ValueError, match="at least one stage"):
        ops.maxplus_stages_batched(dp, kb[:0], vb[:0])
    with pytest.raises(TypeError, match="dp's type"):
        ops.maxplus_stages_batched(dp, kb, vb.float())
    src = mckp_dp.SOURCES["maxplus_stage"].read_text()
    assert "maxplus_stages_batched_f64" in src and "mckp.py:1912" in src
    assert "cudaLaunchAttributeCooperative" in src and "this_grid().sync()" in src


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(stages, rows, nb, k, dtype, seed, dev):
    np_dtype, _ = DTYPES[dtype]
    dp, kb, vb = _inputs(stages, rows, nb, k, np_dtype, seed)
    tmax = np.random.default_rng(seed).integers(-1, nb + 2, rows).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (dp, kb, vb, tmax)]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "stages, rows, nb, k, dtype",
    [
        (40, 1, 4096, 1024, "float64"),  # the fused main path, 2048 nodes
        (7, 3, 1037, 37, "float64"),
        (7, 3, 1037, 37, "float32"),
        (5, 70, 300, 1500, "float64"),  # several items a block, K > KC
        (3, 2, 32768, 64, "float64"),  # dp beyond shared memory: the global route
    ],
)
def test_stages_kernel_matches_plain_on_card(cuda, masked, stages, rows, nb, k, dtype):
    dp, kb, vb, tmax = _card_inputs(stages, rows, nb, k, dtype, nb + k, cuda)
    tmax = tmax if masked else None
    mckp_dp.reset_launches()
    got_dp, got_wins = mckp_dp.maxplus_stages_batched(dp, kb, vb, tmax)
    torch.cuda.synchronize()
    assert mckp_dp.launches["maxplus_stages_batched"] == 1
    want_dp, want_wins = ref.maxplus_stages_batched(dp, kb, vb, tmax)
    _assert_bits(got_dp.cpu().numpy(), want_dp.cpu().numpy())
    _assert_bits(got_wins.cpu().numpy(), want_wins.cpu().numpy())
    resident, blocks, _ = mckp_dp.stages_plan(cuda.index or 0, rows, nb, dp.element_size())
    assert resident == (nb <= 4096) and 1 <= blocks <= rows * -(-nb // 32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stage_kernel_global_route_on_card(cuda, dtype):
    """The single-stage entry at an NB whose dp row does not fit in shared
    memory reads dp from device memory."""
    dp, kb, vb, _ = _card_inputs(1, 2, 65536, 300, dtype, 5, cuda)
    mckp_dp.reset_launches()
    out, arg = mckp_dp.maxplus_stage_batched(dp, kb[0], vb[0])
    torch.cuda.synchronize()
    assert mckp_dp.launches["maxplus_stage_batched"] == 1
    assert mckp_dp.launches["maxplus_stages_batched"] == 0
    want_out, want_arg = ref.maxplus_stage_batched(dp, kb[0], vb[0])
    _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
    _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())
    assert mckp_dp.stages_plan(cuda.index or 0, 2, 65536, dp.element_size())[0] == 0


@pytest.mark.gpu
def test_stages_kernel_graph_capture_on_card(cuda):
    """The multi-stage launch is captured in a CUDA graph and replays the
    eager bits on new inputs copied into the captured buffers."""
    dp, kb, vb, tmax = _card_inputs(40, 1, 4096, 1024, "float64", 3, cuda)
    mckp_dp.maxplus_stages_batched(dp, kb, vb, tmax)  # warm: build, plan
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    mckp_dp.reset_launches()
    with torch.cuda.graph(graph):
        g_dp, g_wins = mckp_dp.maxplus_stages_batched(dp, kb, vb, tmax)
    assert mckp_dp.launches["maxplus_stages_batched"] == 1
    dp2, kb2, vb2, tmax2 = _card_inputs(40, 1, 4096, 1024, "float64", 4, cuda)
    for dst, src in ((dp, dp2), (kb, kb2), (vb, vb2), (tmax, tmax2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want_dp, want_wins = ref.maxplus_stages_batched(dp2, kb2, vb2, tmax2)
    _assert_bits(g_dp.cpu().numpy(), want_dp.cpu().numpy())
    _assert_bits(g_wins.cpu().numpy(), want_wins.cpu().numpy())
