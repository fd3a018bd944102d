"""The serving path's three kernels in the port against the JAX package.

The plain PyTorch versions (``repro_torch.kernels.ref``: ``rmsnorm``,
``mha_reference``, ``decode_attention_reference``) and the wrappers' CPU
route are held against the JAX package's Pallas kernels run in interpret
mode and against its oracles (``repro.kernels.ref``), on the same numpy
inputs, at the shapes of ``tests/test_kernels.py``.  Tolerances, as there:
float32 ``rtol = atol = 2e-5`` (summation order differs between the
frameworks), bf16 ``rtol = atol = 2e-2`` (one bf16 rounding of the output,
~2^-8 relative, on either side).  The reference oracle of decode attention
has no window and no softcap, so those cases are held against the Pallas
kernel alone.  ``gpu``-marked tests build the CUDA kernels and hold them
against the plain versions on the card; they skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdk
from repro.kernels import flash_attention as jfk
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrk
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as tdk
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import rmsnorm as trk

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX and a torch array of type ``name`` (both
    round float32 to bf16 to nearest even, so the bits agree)."""
    jt, tt = DTYPES[name]
    return jnp.asarray(a).astype(jt), torch.from_numpy(a).to(tt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _normal(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64, 256), (3, 100, 128), (1, 1, 512)])
def test_rmsnorm_plain_matches_pallas_and_reference(name, shape):
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, shape)
    scale = 0.1 * _normal(rng, shape[-1:])
    jx, tx = _pair(x, name)
    got = ops.rmsnorm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want_k = jrk.rmsnorm(jx, jnp.asarray(scale), block_rows=32)
    want_r = jref.rmsnorm(jx, jnp.asarray(scale))
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol(name))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol(name))


# ---------------------------------------------------------------------------
# Prefill (flash) attention
# ---------------------------------------------------------------------------


def _qkv(seed, b, sq, skv, hq, hkv, d, name):
    rng = np.random.default_rng(seed)
    arrays = [_normal(rng, (b, sq, hq, d)), _normal(rng, (b, skv, hkv, d)),
              _normal(rng, (b, skv, hkv, d))]
    pairs = [_pair(a, name) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d",
    [
        (2, 128, 128, 4, 4, 64),  # MHA
        (1, 128, 128, 8, 2, 64),  # GQA 4x
        (2, 96, 160, 4, 1, 32),  # MQA, ragged block tails
    ],
)
def test_flash_plain_matches_pallas_and_reference(name, b, sq, skv, hq, hkv, d):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b * sq + hkv, b, sq, skv, hq, hkv, d, name)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_k = jfk.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    want_r = jref.mha_reference(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol(name))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol(name))


@pytest.mark.parametrize("window", [32, 64])
def test_flash_plain_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(window, 1, 128, 128, 4, 4, 32, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want_k = jfk.flash_attention(jq, jk, jv, causal=True, window=window, block_q=32, block_k=32)
    want_r = jref.mha_reference(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol("float32"))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol("float32"))


def test_flash_plain_bidirectional_softcap():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 2, 64, 64, 2, 2, 32, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=False, softcap=30.0)
    want_k = jfk.flash_attention(jq, jk, jv, causal=False, softcap=30.0, block_q=32, block_k=32)
    want_r = jref.mha_reference(jq, jk, jv, causal=False, logit_softcap=30.0)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol("float32"))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol("float32"))


def test_flash_plain_matches_blocked_model_path():
    """The JAX model computes prefill attention in jnp (blocked_attention);
    the port's serving path runs the kernel there, so hold the plain
    version against the blocked path too."""
    from repro.models import blocks as jblocks

    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 128, 128, 8, 2, 32, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=48, softcap=20.0)
    want = jblocks.blocked_attention(jq, jk, jv, causal=True, window=48, softcap=20.0)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def _wgmma_order_attention(q, k, v, *, causal=True, window=None, softcap=None, bq=128, bk=64):
    """Test-only rehearsal of the bf16 CUDA kernel's arithmetic order
    (``flash_attention_wgmma_kernel``) in torch on the CPU: q-tiles of
    ``bq`` rows, key tiles of ``bk`` from the window's first tile (rounded
    down to ``bk``) to the causal bound; S = Q K^T as bf16 products summed
    in float32, the scale applied to S, the softcap, masked logits at
    -1e30 with zero probability, online softmax with float32 m and l, P
    rounded to bf16 before P V, O in float32, out = O / max(l, 1e-30)
    rounded to q's type.  Not a plain version: nothing on the main path
    calls it."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)  # [b, hkv, g, sq, d]
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # [b, hkv, 1, skv, d]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    out = torch.empty(b, hkv, g, sq, d)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        kv_end = min(skv, q0 + bq) if causal else skv
        kv_begin = (max(0, q0 - window + 1) // bk) * bk if window else 0
        m = torch.full((b, hkv, g, len(rows), 1), -1e30)
        l = torch.zeros(b, hkv, g, len(rows), 1)
        o = torch.zeros(b, hkv, g, len(rows), d)
        for t0 in range(kv_begin, kv_end, bk):
            cols = torch.arange(t0, min(t0 + bk, skv))
            s = (qf[:, :, :, rows] @ kf[:, :, :, cols].transpose(-1, -2)) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                ok &= rows[:, None] >= cols[None, :]
            if window is not None:
                ok &= rows[:, None] - cols[None, :] < window
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new), torch.tensor(0.0))
            l = corr * l + p.sum(-1, keepdim=True)
            o = corr * o + p.to(torch.bfloat16).float() @ vf[:, :, :, cols]
            m = m_new
        out[:, :, :, rows] = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window,softcap",
    [
        (1, 512, 32, 8, 64, None, None),  # granite-3-2b's heads
        (1, 512, 8, 2, 128, None, None),  # mistral-nemo / gemma3 head dim
        (1, 512, 32, 8, 64, 128, None),
        (1, 512, 32, 8, 64, None, 30.0),
    ],
)
def test_bf16_probabilities_stay_within_kernel_tolerance(b, s, hq, hkv, d, window, softcap):
    """Rounding P to bf16 before P V (the bf16 kernel's one departure from
    the TPU kernel's float32 P) keeps the output within the bf16 tolerance
    of the float32-softmax oracle, on the same bf16 inputs."""
    _, (q, k, v) = _qkv(d + (window or 0), b, s, s, hq, hkv, d, "bfloat16")
    got = _wgmma_order_attention(q, k, v, causal=True, window=window, softcap=softcap)
    want = ref.mha_reference(q, k, v, causal=True, window=window, logit_softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("bfloat16"))


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(seed, b, s, hq, hkv, d, name, lengths=None):
    rng = np.random.default_rng(seed)
    q, kc, vc = _normal(rng, (b, hq, d)), _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
    if lengths is None:
        lengths = rng.integers(1, s + 1, (b,))
    lengths = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, name) for a in (q, kc, vc))
    return (jq, jk, jv, jnp.asarray(lengths)), (tq, tk, tv, torch.from_numpy(lengths))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "b,s,hq,hkv,d", [(4, 256, 8, 2, 64), (2, 200, 4, 4, 32), (3, 512, 16, 8, 64)]
)
def test_decode_plain_matches_pallas_and_reference(name, b, s, hq, hkv, d):
    j_in, t_in = _decode_inputs(b * s + hq, b, s, hq, hkv, d, name)
    got = ops.decode_attention(*t_in)
    assert got.dtype == t_in[0].dtype and got.shape == t_in[0].shape
    want_k = jdk.decode_attention(*j_in, block_k=64)
    want_r = jref.decode_attention_reference(*j_in)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol(name))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol(name))


def test_decode_plain_length_one():
    j_in, t_in = _decode_inputs(1, 2, 128, 4, 2, 32, "float32", lengths=[1, 1])
    got = ops.decode_attention(*t_in)
    want_k = jdk.decode_attention(*j_in, block_k=64)
    want_r = jref.decode_attention_reference(*j_in)
    np.testing.assert_allclose(_f32(got), _f32(want_k), **_tol("float32"))
    np.testing.assert_allclose(_f32(got), _f32(want_r), **_tol("float32"))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(32, None), (None, 30.0), (64, 30.0), (1, None)])
def test_decode_plain_window_softcap_matches_pallas(name, window, softcap):
    """No reference oracle takes a window or a softcap: the Pallas kernel is
    the reference here.  Lengths include 1, a full cache and a length
    shorter than the window."""
    j_in, t_in = _decode_inputs(
        7, 4, 256, 8, 2, 64, name, lengths=[1, 256, 20, 131]
    )
    got = ops.decode_attention(*t_in, window=window, softcap=softcap)
    want = jdk.decode_attention(*j_in, window=window, softcap=softcap, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


def _split_decode_model(q, kc, vc, lengths, *, splits, slots=4, window=None, softcap=None):
    """Decode attention as the split-KV kernel (csrc/decode_attention.cu)
    computes it, in float32 numpy: each of ``splits`` blocks of a (sequence,
    KV head) takes its even share of the valid keys; inside, ``slots`` key
    streams each run the one-expf online softmax over every ``slots``-th
    key, merged pairwise; the combine weights every partial by e^(m_i - m)
    and divides by max(l, 1e-30)."""
    q, kc, vc = (np.asarray(a, np.float32) for a in (q, kc, vc))
    b, hq, d = q.shape
    _, s, hkv, _ = kc.shape
    group = hq // hkv
    neg = np.float32(-1e30)
    out = np.zeros((b, hq, d), np.float32)

    def merge(a, c):
        mx = np.maximum(a[0], c[0])
        wa, wc = np.exp(a[0] - mx), np.exp(c[0] - mx)
        return mx, a[1] * wa + c[1] * wc, a[2] * wa[:, None] + c[2] * wc[:, None]

    for bi in range(b):
        n_len = int(lengths[bi])
        end = min(n_len, s)
        begin = max(0, n_len - window) if window else 0
        n = max(0, end - begin)
        for hk in range(hkv):
            qs = q[bi, hk * group : (hk + 1) * group] * np.float32(1.0 / np.sqrt(d))
            parts = []
            for sp in range(splits):
                lo, hi = begin + n * sp // splits, begin + n * (sp + 1) // splits
                streams = []
                for sl in range(slots):
                    m = np.full(group, neg)
                    den = np.zeros(group, np.float32)
                    acc = np.zeros((group, d), np.float32)
                    for j in range(lo + sl, hi, slots):
                        x = qs @ kc[bi, j, hk]
                        if softcap:
                            x = np.float32(softcap) * np.tanh(x / np.float32(softcap))
                        e = np.exp(-np.abs(x - m))
                        up = x > m
                        cs, pr = np.where(up, e, 1.0), np.where(up, 1.0, e)
                        m = np.where(up, x, m)
                        den = den * cs + pr
                        acc = acc * cs[:, None] + pr[:, None] * vc[bi, j, hk][None, :]
                    streams.append((m, den, acc))
                while len(streams) > 1:
                    streams = [merge(streams[i], streams[i + 1]) for i in range(0, len(streams), 2)]
                parts.append(streams[0])
            mx = np.max([pt[0] for pt in parts], axis=0)
            den = sum(np.exp(pt[0] - mx) * pt[1] for pt in parts)
            num = sum(np.exp(pt[0] - mx)[:, None] * pt[2] for pt in parts)
            out[bi, hk * group : (hk + 1) * group] = num / np.maximum(den, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 7, 8])
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,lengths,window,softcap",
    [
        (3, 96, 8, 2, 64, [1, 50, 96], None, None),  # length 1: splits left empty
        (4, 64, 16, 1, 32, [64, 5, 33, 2], None, None),  # group 16
        (3, 80, 4, 2, 80, [80, 40, 3], 2, None),  # window 2: most splits empty; head dim 80
        (2, 128, 8, 2, 32, [128, 70], 48, 30.0),
    ],
)
def test_split_decode_model_matches_reference_and_pallas(splits, b, s, hq, hkv, d, lengths,
                                                         window, softcap):
    j_in, t_in = _decode_inputs(s + d, b, s, hq, hkv, d, "float32", lengths=lengths)
    got = _split_decode_model(*(t.numpy() for t in t_in), splits=splits, window=window,
                              softcap=softcap)
    want = ref.decode_attention_reference(*t_in, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want.numpy(), **_tol("float32"))
    want_k = jdk.decode_attention(*j_in, window=window, softcap=softcap, block_k=32)
    np.testing.assert_allclose(got, _f32(want_k), **_tol("float32"))


def _scaled_attention(q, k, v, *, scale, causal):
    """float32 attention with the logits' factor given, as the flash kernel
    takes it: the model of a launch at the padded head dim."""
    b, tq, hq, _ = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, tq, hkv, hq // hkv, -1)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k) * scale
    if causal:
        tk = k.shape[1]
        keep = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
        logits = torch.where(keep, logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, tq, hq, -1)


def test_flash_kernel_head_dims():
    assert [tfk.kernel_head_dim(d) for d in (8, 32, 40, 64, 80, 128)] == [32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="head dim"):
        tfk.kernel_head_dim(136)
    x = torch.ones(2, 3, 4, 64)
    assert tfk.pad_head_dim(x, 64) is x


@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dim_80_through_padding(causal):
    """Head dim 80 runs the D = 128 kernel on zero-padded q, k, v with the
    scale 1/sqrt(80): the same function as attention at 80, to float32
    rounding (the padded sum adds exact zeros; the logits multiply by
    1/sqrt(80) where the plain version divides by sqrt(80))."""
    (jq, jk, jv), (q, k, v) = _qkv(80 + causal, 2, 64, 64, 4, 2, 80, "float32")
    dk = tfk.kernel_head_dim(80)
    assert dk == 128
    qp, kp, vp = (tfk.pad_head_dim(t, dk) for t in (q, k, v))
    assert qp.shape[-1] == dk and torch.equal(qp[..., 80:], torch.zeros_like(qp[..., 80:]))
    got = _scaled_attention(qp, kp, vp, scale=1.0 / np.sqrt(80), causal=causal)[..., :80]
    want = ref.mha_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    want_k = jfk.flash_attention(jq, jk, jv, causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), _f32(want_k), **_tol("float32"))


# ---------------------------------------------------------------------------
# Routes, wrappers and sources
# ---------------------------------------------------------------------------


def test_cpu_route_takes_plain_version_without_launching():
    build.reset_launches()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_normal(rng, (3, 64)))
    s = torch.from_numpy(0.1 * _normal(rng, (64,)))
    assert torch.equal(ops.rmsnorm(x, s, eps=1e-5), ref.rmsnorm(x, s, 1e-5))
    (_, (q, k, v)) = _qkv(1, 1, 16, 16, 4, 2, 32, "float32")
    assert torch.equal(
        ops.flash_attention(q, k, v, window=4, softcap=5.0),
        ref.mha_reference(q, k, v, window=4, logit_softcap=5.0),
    )
    _, t_in = _decode_inputs(2, 2, 16, 4, 2, 32, "float32")
    assert torch.equal(
        ops.decode_attention(*t_in, window=3), ref.decode_attention_reference(*t_in, window=3)
    )
    assert all(n == 0 for n in build.launches.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        trk.rmsnorm(x, torch.zeros(64))
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        tdk.decode_attention(q[:, 0], q[:, :, :2], q[:, :, :2], torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="bad shapes"):
        tfk.flash_attention(q, q[:, :, :3], q[:, :, :2])


def test_kernel_sources_name_the_replaced_tpu_kernels():
    for name, pallas in (
        ("rmsnorm", "src/repro/kernels/rmsnorm.py:27"),
        ("flash_attention", "src/repro/kernels/flash_attention.py:114"),
        ("decode_attention", "src/repro/kernels/decode_attention.py:96"),
    ):
        src = build.SOURCES[name].read_text()
        assert pallas in src and "Bound:" in src and "Design:" in src
        assert "return static_cast<int>(cudaGetLastError());" in src
        assert "__expf" not in src and "__fdividef" not in src
        assert build.library_path(name).parent == build.BUILD_DIR
    assert "--use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert set(build.launches) == {
        "maxplus_conv", "maxplus_conv_batched", "maxplus_stage_batched",
        "maxplus_stages_batched", "rmsnorm", "flash_attention", "decode_attention",
    }


def test_flash_source_names_one_kernel_per_type():
    src = build.SOURCES["flash_attention"].read_text()
    for needle in (
        "flash_attention_wgmma_kernel", "flash_attention_simt_kernel", "wgmma.mma_async",
        "cp.async.bulk.tensor.4d", "__grid_constant__", "cudaGetDriverEntryPoint",
        "cudaFuncAttributeMaxDynamicSharedMemorySize",
    ):
        assert needle in src, needle
    assert "-lcuda" not in " ".join(build.NVCC_FLAGS)


def test_aligned_copies_only_what_the_kernels_cannot_take():
    t = torch.zeros(4, 64)
    assert build.aligned(t) is t
    sl = torch.zeros(4, 128)[:, :64]  # not contiguous
    got = build.aligned(sl)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, sl)
    off = torch.zeros(65)[1:]  # contiguous, 4 bytes past an aligned base
    got = build.aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card(t_in, dev):
    return [t.to(dev) for t in t_in]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", [(4096, 2048), (8, 2048), (3, 100, 128), (2, 77)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, name, shape):
    rng = np.random.default_rng(len(shape))
    _, x = _pair(_normal(rng, shape), name)
    s = torch.from_numpy(0.1 * _normal(rng, shape[-1:]))
    x, s = x.to(cuda), s.to(cuda)
    build.reset_launches()
    got = trk.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert build.launches["rmsnorm"] == 1
    np.testing.assert_allclose(_f32(got.cpu()), _f32(ref.rmsnorm(x, s).cpu()), **_tol(name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,causal,window,softcap",
    [
        (2, 512, 512, 32, 8, 64, True, None, None),
        (2, 96, 160, 4, 1, 32, True, None, None),
        (1, 300, 300, 8, 2, 64, True, 64, None),
        (2, 64, 64, 2, 2, 32, False, None, 30.0),
        (1, 200, 200, 4, 2, 128, True, 32, 50.0),
    ],
)
def test_flash_kernel_matches_plain_on_card(cuda, name, b, sq, skv, hq, hkv, d, causal,
                                            window, softcap):
    _, t_in = _qkv(sq + d, b, sq, skv, hq, hkv, d, name)
    q, k, v = _card(t_in, cuda)
    build.reset_launches()
    got = tfk.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 1
    want = ref.mha_reference(q, k, v, causal=causal, window=window, logit_softcap=softcap)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), **_tol(name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,lengths,window,softcap",
    [
        (8, 1024, 32, 8, 64, [513, 520, 527, 530, 535, 538, 540, 543], None, None),
        (3, 200, 4, 4, 32, [1, 77, 200], None, None),
        (4, 256, 8, 2, 64, [1, 100, 256, 31], 32, 30.0),
        (2, 300, 32, 2, 128, [300, 5], 64, None),
        (2, 256, 32, 2, 128, [256, 17], None, None),  # group 16 (chatglm3-6b)
        (3, 200, 8, 4, 80, [1, 150, 200], 64, None),  # head dim 80
        (8, 8192, 32, 8, 64, [4000, 4600, 5200, 5800, 6400, 7000, 7600, 8192], None,
         None),  # a long cache
    ],
)
def test_decode_kernel_matches_plain_on_card(cuda, name, b, s, hq, hkv, d, lengths, window,
                                             softcap):
    _, t_in = _decode_inputs(s, b, s, hq, hkv, d, name, lengths=lengths)
    q, kc, vc, lens = _card(t_in, cuda)
    build.reset_launches()
    got = tdk.decode_attention(q, kc, vc, lens, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert build.launches["decode_attention"] == 1
    want = ref.decode_attention_reference(q, kc, vc, lens, window=window, softcap=softcap)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), **_tol(name))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,sq,hq,hkv,d,causal,window,softcap",
    [
        (2, 512, 32, 8, 128, True, None, None),  # head dim 128
        (1, 256, 32, 2, 64, True, None, None),  # group 16 (chatglm3-6b)
        (2, 200, 8, 2, 64, True, None, None),  # ragged ends: TMA zero fill per sequence
        (3, 300, 4, 1, 128, True, None, None),
        (2, 77, 4, 4, 32, False, None, None),
        (2, 300, 8, 2, 64, True, 100, 30.0),  # window and softcap together
    ],
)
def test_flash_bf16_wgmma_kernel_on_card(cuda, b, sq, hq, hkv, d, causal, window, softcap):
    _, t_in = _qkv(sq * d + hq, b, sq, sq, hq, hkv, d, "bfloat16")
    q, k, v = _card(t_in, cuda)
    build.reset_launches()
    got = tfk.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 1
    want = ref.mha_reference(q, k, v, causal=causal, window=window, logit_softcap=softcap)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), **_tol("bfloat16"))


def _replayed(fn):
    """fn() captured in a CUDA graph and replayed once: its output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
def test_flash_bf16_graph_replay_matches_eager(cuda):
    _, t_in = _qkv(5, 2, 300, 300, 8, 2, 64, "bfloat16")
    q, k, v = _card(t_in, cuda)
    eager = tfk.flash_attention(q, k, v, window=128)
    assert torch.equal(_replayed(lambda: tfk.flash_attention(q, k, v, window=128)), eager)


@pytest.mark.gpu
def test_decode_graph_replay_matches_eager(cuda):
    lengths = [513, 520, 527, 530, 535, 538, 540, 543]
    _, t_in = _decode_inputs(9, 8, 1024, 32, 8, 64, "bfloat16", lengths=lengths)
    q, kc, vc, lens = _card(t_in, cuda)
    eager = tdk.decode_attention(q, kc, vc, lens)
    assert torch.equal(_replayed(lambda: tdk.decode_attention(q, kc, vc, lens)), eager)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "hq,causal", [(32, True), (16, False)], ids=["zamba2-causal", "hubert-bidirectional"]
)
def test_flash_kernel_head_dim_80_on_card(cuda, name, hq, causal):
    _, t_in = _qkv(hq + causal, 2, 512, 512, hq, hq, 80, name)
    q, k, v = _card(t_in, cuda)
    build.reset_launches()
    got = tfk.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 1 and got.shape == q.shape
    want = ref.mha_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), **_tol(name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", [4096, 5120, 5376])
def test_rmsnorm_kernel_ported_widths_on_card(cuda, name, d):
    rng = np.random.default_rng(d)
    _, x = _pair(_normal(rng, (64, d)), name)
    s = torch.from_numpy(0.1 * _normal(rng, (d,)))
    x, s = x.to(cuda), s.to(cuda)
    got = trk.rmsnorm(x, s)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(ref.rmsnorm(x, s).cpu()), **_tol(name))


@pytest.mark.gpu
def test_rmsnorm_graph_replay_matches_eager(cuda):
    rng = np.random.default_rng(11)
    _, x = _pair(_normal(rng, (512, 2048)), "bfloat16")
    x, s = x.to(cuda), torch.from_numpy(0.1 * _normal(rng, (2048,))).to(cuda)
    assert torch.equal(_replayed(lambda: trk.rmsnorm(x, s)), trk.rmsnorm(x, s))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
def test_rmsnorm_non_contiguous_input_on_card(cuda, name):
    rng = np.random.default_rng(12)
    _, x = _pair(_normal(rng, (16, 3, 2048)), name)
    x = x.to(cuda)[:, 1]  # every third row: not contiguous
    s = torch.from_numpy(0.1 * _normal(rng, (2048,))).to(cuda)
    assert not x.is_contiguous()
    got = trk.rmsnorm(x, s)
    assert got.shape == x.shape
    np.testing.assert_allclose(_f32(got.cpu()), _f32(ref.rmsnorm(x, s).cpu()), **_tol(name))
