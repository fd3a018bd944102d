"""The port's (max,+) DP stage against the JAX package, bit for bit.

The plain PyTorch version (``repro_torch.kernels.ref``) and the wrappers'
CPU route are held against ``repro.kernels.ref.maxplus_conv`` and against
the Pallas kernels run in interpret mode, on the same numpy inputs.  The
stage only adds and compares in float32, so the tolerance is zero: every
output is compared as raw bits.  ``gpu``-marked tests build the CUDA kernel
and hold it against the plain version on the card; they skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mckp_dp, ops, ref

NBS = [1, 7, 256, 300, 1000]

# the shapes here are tiny: one intra-op thread keeps this file from
# crowding the other test workers' cores
torch.set_num_threads(1)


def _inputs(rows: int, nb: int, seed: int):
    """dp, f [rows, nb] float32 on a 1/8 lattice (many exact ties, so the
    smallest-argmax rule is exercised) with some -inf curve entries."""
    rng = np.random.default_rng(seed)
    dp = (np.round(rng.uniform(0, 4, (rows, nb)) * 8) / 8).astype(np.float32)
    f = (np.round(rng.uniform(0, 4, (rows, nb)) * 8) / 8).astype(np.float32)
    f[rng.random((rows, nb)) < 0.1] = -np.inf
    f[:, 0] = 0.0
    return dp, f


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("nb", NBS)
def test_plain_conv_matches_reference(nb):
    dp, f = _inputs(1, nb, seed=nb)
    out, arg = ref.maxplus_conv(torch.from_numpy(dp[0]), torch.from_numpy(f[0]))
    w_out, w_arg = jref.maxplus_conv(jnp.asarray(dp[0]), jnp.asarray(f[0]))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)


@pytest.mark.parametrize("nb", NBS)
def test_conv_matches_pallas_interpret(nb):
    dp, f = _inputs(1, nb, seed=nb + 1)
    out, arg = ops.maxplus_conv(torch.from_numpy(dp[0]), torch.from_numpy(f[0]))
    w_out, w_arg = jops.maxplus_conv(jnp.asarray(dp[0]), jnp.asarray(f[0]))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("nb", NBS)
def test_batched_conv_matches_reference_and_pallas(rows, nb):
    dp, f = _inputs(rows, nb, seed=10 * nb + rows)
    out, arg = ops.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    w_out, w_arg = jops.maxplus_conv_batched(jnp.asarray(dp), jnp.asarray(f))
    _assert_bits(out.numpy(), w_out)
    _assert_bits(arg.numpy(), w_arg)
    for r in range(rows):
        r_out, r_arg = jref.maxplus_conv(jnp.asarray(dp[r]), jnp.asarray(f[r]))
        _assert_bits(out[r].numpy(), r_out)
        _assert_bits(arg[r].numpy(), r_arg)


def test_scans_match_pallas_interpret():
    rng = np.random.default_rng(7)
    leaves, classes, stages, nb = 3, 4, 6, 300
    f_groups = np.maximum.accumulate(
        rng.uniform(0, 1, (leaves, classes, nb)), axis=2
    ).astype(np.float32)
    f_groups[..., 0] = 0.0
    gids = rng.integers(0, classes, (leaves, stages)).astype(np.int32)

    dp, args = ops.maxplus_scan_batched(
        torch.from_numpy(f_groups), torch.from_numpy(gids).long()
    )
    w_dp, w_args = jops.maxplus_scan_batched(jnp.asarray(f_groups), gids)
    _assert_bits(dp.numpy(), w_dp)
    _assert_bits(args.numpy(), w_args)

    dp1, args1 = ops.maxplus_scan(
        torch.from_numpy(f_groups[0]), torch.from_numpy(gids[0]).long()
    )
    w_dp1, w_args1 = jops.maxplus_scan(jnp.asarray(f_groups[0]), gids[0])
    _assert_bits(dp1.numpy(), w_dp1)
    _assert_bits(args1.numpy(), w_args1)


# ---------------------------------------------------------------------------
# The CUDA kernel's decomposition (csrc/maxplus_conv.cu), modelled in numpy
# ---------------------------------------------------------------------------


def _key(val: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit merge key: the float's order-preserving bits, with
    -0.0 read as +0.0, over 0xFFFFFFFF - k."""
    u = val.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (u.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - k.astype(np.uint64)
    )


def _decomposed_conv(dp, f, *, bt, warps, kw, g):
    """out, arg as the kernel computes them: items of (b-tile of ``bt``
    outputs, k-chunk of ``warps * kw``) below the diagonal; inside an item
    each warp scans its ``kw`` candidates in groups of ``g`` (group max,
    strict ``>`` over groups, then the first k of the kept group equal to
    the max); the warps merge in ascending k with strict ``>``; the items
    merge by max of the 64-bit key; the decode recomputes dp[b - k] + f[k]."""
    rows, nb = dp.shape
    kc = warps * kw
    keys = np.zeros((rows, nb), np.uint64)
    neg = np.float32(-np.inf)
    for r in range(rows):
        for b0 in range(0, nb, bt):
            bs = np.arange(b0, min(b0 + bt, nb))
            for k0 in range(0, int(bs[-1]) + 1, kc):
                ks = np.arange(k0, k0 + kc)
                idx = bs[:, None] - ks[None, :]
                dpv = np.where((idx >= 0) & (idx < nb), dp[r, np.clip(idx, 0, nb - 1)], neg)
                fv = np.where(ks < nb, f[r, np.clip(ks, 0, nb - 1)], neg)
                cand = (dpv + fv[None, :]).astype(np.float32)  # [outputs, kc]
                best = np.full(len(bs), neg)
                kbest = np.full(len(bs), k0)
                for w in range(warps):
                    kws = k0 + w * kw
                    groups = cand[:, w * kw : (w + 1) * kw].reshape(len(bs), kw // g, g)
                    gmax = groups.max(axis=2)
                    acc = np.full(len(bs), neg)
                    grp = np.zeros(len(bs), np.int64)
                    for gi in range(kw // g):
                        up = gmax[:, gi] > acc
                        acc = np.where(up, gmax[:, gi], acc)
                        grp = np.where(up, gi, grp)
                    inner = groups[np.arange(len(bs)), grp] == acc[:, None]
                    k_w = kws + g * grp + inner.argmax(axis=1)
                    up = (kws <= bs) & (acc > best)
                    best = np.where(up, acc, best)
                    kbest = np.where(up, k_w, kbest)
                live = k0 <= bs
                keys[r, bs[live]] = np.maximum(keys[r, bs[live]], _key(best, kbest)[live])
    arg = (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF))).astype(np.int64)
    rows_i = np.arange(rows)[:, None]
    out = (dp[rows_i, np.arange(nb)[None, :] - arg] + f[rows_i, arg]).astype(np.float32)
    return out, arg.astype(np.int32)


def _signed_zero_rows(rows: int, nb: int, seed: int):
    """dp, f whose row maxima are 0.0 reached by -0.0 and +0.0 candidates
    alike (-0 + -0 = -0, +0 + -0 = +0): the merge must keep the smallest
    such k and the decode that k's sign."""
    rng = np.random.default_rng(seed)
    dp = rng.choice(np.array([-0.0, 0.0, -1.0, -2.5], np.float32), (rows, nb))
    f = rng.choice(np.array([-0.0, 0.0, -0.5, -np.inf], np.float32), (rows, nb))
    dp[:, 0] = -0.0
    f[:, 0] = -0.0
    return dp, f


# the kernel's own sizes, and small ones that cut NB = 129 into many items
DECOMPOSITIONS = [dict(bt=256, warps=8, kw=128, g=8), dict(bt=16, warps=4, kw=8, g=4)]


@pytest.mark.parametrize("sizes", DECOMPOSITIONS, ids=["kernel", "small"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("nb", [1, 7, 129, 1037])
def test_decomposed_conv_matches_reference_and_pallas(sizes, rows, nb):
    dp, f = _inputs(rows, nb, seed=100 * nb + rows)
    if rows == 3:
        dp[1] = -np.inf  # every candidate -inf: out -inf, arg 0
        dp[2], f[2] = _signed_zero_rows(1, nb, seed=nb)
    out, arg = _decomposed_conv(dp, f, **sizes)
    want_out, want_arg = ref.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    _assert_bits(out, want_out.numpy())
    _assert_bits(arg, want_arg.numpy())
    w_out, w_arg = jops.maxplus_conv_batched(jnp.asarray(dp), jnp.asarray(f))
    _assert_bits(out, w_out)
    _assert_bits(arg, w_arg)
    if rows == 3:
        assert np.all(arg[1] == 0) and np.all(np.isneginf(out[1]))


def test_merge_key_orders_as_the_scan():
    vals = np.array([-np.inf, -3.5, -0.0, 0.0, 0.0, 1.25, 1.25], np.float32)
    ks = np.array([9, 0, 7, 3, 8, 5, 2])
    keys = _key(vals, ks)
    # larger value first, then the smaller k; -0.0 and +0.0 tie
    assert list(np.argsort(keys)[::-1]) == [6, 5, 3, 2, 4, 1, 0]
    assert _key(np.float32([-np.inf]), np.array([0]))[0] > 0  # above the zeroed buffer


def test_cpu_route_takes_plain_version_without_launching():
    mckp_dp.reset_launches()
    dp, f = _inputs(2, 64, seed=3)
    out, arg = ops.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    want_out, want_arg = ref.maxplus_conv_batched(
        torch.from_numpy(dp), torch.from_numpy(f)
    )
    _assert_bits(out.numpy(), want_out.numpy())
    _assert_bits(arg.numpy(), want_arg.numpy())
    assert mckp_dp.launches == {
        "maxplus_conv": 0, "maxplus_conv_batched": 0, "maxplus_stage_batched": 0,
        "maxplus_stages_batched": 0, "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
    }


def test_kernel_wrapper_refuses_cpu_tensors():
    dp, f = _inputs(1, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        mckp_dp.maxplus_conv_batched(torch.from_numpy(dp), torch.from_numpy(f))
    with pytest.raises(ValueError, match="equal-shape"):
        ops.maxplus_conv_batched(torch.zeros(2, 3), torch.zeros(2, 4))


def test_kernel_source_names_the_replaced_tpu_kernels():
    src = mckp_dp.SOURCES["maxplus_conv"].read_text()
    assert "maxplus_conv_pallas_batched" in src and "maxplus_conv_pallas" in src
    assert "--use_fast_math" not in " ".join(mckp_dp.NVCC_FLAGS)
    assert mckp_dp.library_path("maxplus_conv").parent == mckp_dp.BUILD_DIR


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows, nb",
    [(1, 1), (1, 7), (1, 11288), (8, 1000), (3, 300), (2, 129), (8, 11288),
     (1, 16384), (8, 16384), (1, 65536)],
)
def test_kernel_matches_plain_on_card(cuda, rows, nb):
    dp, f = _inputs(rows, nb, seed=rows * nb)
    dp_t = torch.from_numpy(dp).to(cuda)
    f_t = torch.from_numpy(f).to(cuda)
    mckp_dp.reset_launches()
    out, arg = mckp_dp.maxplus_conv_batched(dp_t, f_t)
    torch.cuda.synchronize()
    assert mckp_dp.launches["maxplus_conv_batched"] == 1
    want_out, want_arg = ref.maxplus_conv_batched(dp_t, f_t)
    _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
    _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())
    for r in range(rows):
        s_out, s_arg = ops.maxplus_conv(dp_t[r], f_t[r])
        _assert_bits(s_out.cpu().numpy(), out[r].cpu().numpy())
        _assert_bits(s_arg.cpu().numpy(), arg[r].cpu().numpy())
    assert mckp_dp.launches["maxplus_conv"] == rows


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [129, 1037, 11288])
def test_kernel_signed_zero_and_neg_inf_rows_on_card(cuda, nb):
    dp, f = _inputs(3, nb, seed=nb)
    dp[1] = -np.inf
    dp[2], f[2] = _signed_zero_rows(1, nb, seed=nb)
    dp_t, f_t = torch.from_numpy(dp).to(cuda), torch.from_numpy(f).to(cuda)
    out, arg = mckp_dp.maxplus_conv_batched(dp_t, f_t)
    want_out, want_arg = ref.maxplus_conv_batched(dp_t, f_t)
    _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
    _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())
    assert bool((arg[1] == 0).all())


@pytest.mark.gpu
def test_kernel_workspace_per_call_on_card(cuda):
    """Calls of other shapes, one after another and on a second stream, each
    give the plain version's bits; a CUDA graph captured at one shape
    replays the eager result after a larger call has run in between."""
    cases = [_inputs(rows, nb, seed=rows + nb) for rows, nb in ((2, 5000), (1, 300), (2, 5000))]
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for dp, f in cases:
                dp_t, f_t = torch.from_numpy(dp).to(cuda), torch.from_numpy(f).to(cuda)
                out, arg = mckp_dp.maxplus_conv_batched(dp_t, f_t)
                want_out, want_arg = ref.maxplus_conv_batched(dp_t, f_t)
                _assert_bits(out.cpu().numpy(), want_out.cpu().numpy())
                _assert_bits(arg.cpu().numpy(), want_arg.cpu().numpy())
    torch.cuda.synchronize()

    dp, f = (torch.from_numpy(x).to(cuda) for x in _inputs(2, 3000, seed=7))
    want_out, want_arg = mckp_dp.maxplus_conv_batched(dp, f)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_arg = mckp_dp.maxplus_conv_batched(dp, f)
    big_dp, big_f = (torch.from_numpy(x).to(cuda) for x in _inputs(4, 12000, seed=8))
    big_out, big_arg = mckp_dp.maxplus_conv_batched(big_dp, big_f)
    for _ in range(3):
        g_out.fill_(0.0)
        g_arg.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        _assert_bits(g_out.cpu().numpy(), want_out.cpu().numpy())
        _assert_bits(g_arg.cpu().numpy(), want_arg.cpu().numpy())
    want_big = ref.maxplus_conv_batched(big_dp, big_f)
    _assert_bits(big_out.cpu().numpy(), want_big[0].cpu().numpy())
    _assert_bits(big_arg.cpu().numpy(), want_big[1].cpu().numpy())


@pytest.mark.gpu
def test_kernel_refuses_float64_on_card(cuda):
    x = torch.zeros(1, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        mckp_dp.maxplus_conv_batched(x, x)


def test_jax_stays_on_cpu_with_x64_off():
    assert jax.default_backend() == "cpu"
    assert not jax.config.jax_enable_x64
