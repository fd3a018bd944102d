"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic ground truth its CUDA kernel is held
against on the card and the path a kernel wrapper takes for CPU tensors;
the dense convolution is also the ``"jax"`` backend of the dense solvers
(the name is kept from the JAX package, where it selects the pure-jnp
path).  The serving path's three (RMSNorm, prefill attention, decode
attention) are the JAX package's oracles of its Pallas kernels.
"""

from __future__ import annotations

import torch


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor, chunk: int = 512):
    """Row-batched tropical-semiring convolution.

    dp, f: [R, NB].  ``out[r, b] = max_{0<=k<=b} dp[r, b-k] + f[r, k]`` and
    ``arg[r, b]`` is the smallest maximizing ``k`` (int32), exactly
    ``repro.kernels.ref.maxplus_conv`` on each row.  Evaluated in b-chunks
    so the [R, chunk, NB] candidate tile bounds the memory footprint.
    """
    if dp.ndim != 2 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-shape 2D, got {dp.shape} {f.shape}")
    r, nb = dp.shape
    # left pad NB entries of -inf: index NB + b - k is in-bounds for every
    # k <= NB - 1 and reads -inf exactly where b - k < 0
    dp_pad = torch.cat([torch.full_like(dp, -torch.inf), dp], dim=1)
    ks = torch.arange(nb, device=dp.device)
    out = torch.empty_like(dp)
    arg = torch.empty((r, nb), dtype=torch.int32, device=dp.device)
    for b0 in range(0, nb, chunk):
        b = torch.arange(b0, min(b0 + chunk, nb), device=dp.device)
        cand = dp_pad[:, nb + b[:, None] - ks[None, :]] + f[:, None, :]
        a = cand.argmax(dim=2)  # first maximal index: the smallest k
        out[:, b0 : b0 + len(b)] = cand.gather(2, a[..., None])[..., 0]
        arg[:, b0 : b0 + len(b)] = a.to(torch.int32)
    return out, arg


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor, chunk: int = 512):
    """Single-row form of :func:`maxplus_conv_batched`: dp, f: [NB]."""
    if dp.ndim != 1 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-length 1D, got {dp.shape} {f.shape}")
    out, arg = maxplus_conv_batched(dp[None], f[None], chunk)
    return out[0], arg[0]


def maxplus_stage_batched(
    dp: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, chunk_elems: int = 1 << 22
):
    """Row-batched sparse-option (max,+) stage with a first-max backpointer.

    dp: [R, NB]; kb: [R, K] integer spend offsets; vb: [R, K] option values
    of dp's type.  ``out[r, b] = max_j dp[r, b - kb[r, j]] + vb[r, j]`` with
    ``dp[r, i]`` read as -inf for ``i`` outside ``[0, NB)``, and ``arg[r, b]``
    the first maximizing ``j`` (int32; 0 where every candidate is -inf) —
    ``repro.kernels.mckp_dp.maxplus_stage_pallas_batched`` row by row, in
    the input type.  Evaluated in b-chunks of an [R, K, chunk] candidate
    tile; ``argmax`` over ``j`` returns the first maximal index.
    """
    if dp.ndim != 2 or kb.ndim != 2 or kb.shape != vb.shape or kb.shape[0] != dp.shape[0]:
        raise ValueError(
            f"bad shapes dp={tuple(dp.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)}"
        )
    if vb.dtype != dp.dtype:
        raise TypeError(f"vb must have dp's type {dp.dtype}, got {vb.dtype}")
    r, nb = dp.shape
    k = kb.shape[1]
    if k == 0:
        raise ValueError("a stage needs at least one option")
    kb64 = kb.to(torch.int64)
    rows = torch.arange(r, device=dp.device)[:, None, None]
    out = torch.empty_like(dp)
    arg = torch.empty((r, nb), dtype=torch.int32, device=dp.device)
    chunk = max(1, chunk_elems // (r * k))
    for b0 in range(0, nb, chunk):
        b = torch.arange(b0, min(b0 + chunk, nb), device=dp.device)
        idx = b[None, None, :] - kb64[:, :, None]  # [R, K, chunk]
        x = dp[rows, idx.clamp(0, nb - 1)]
        x = torch.where((idx >= 0) & (idx < nb), x, -torch.inf)
        cand = x + vb[:, :, None]
        a = cand.argmax(dim=1)  # first maximal j
        out[:, b0 : b0 + len(b)] = cand.gather(1, a[:, None, :])[:, 0, :]
        arg[:, b0 : b0 + len(b)] = a.to(torch.int32)
    return out, arg


def maxplus_stages_batched(
    dp0: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, tmax: torch.Tensor | None = None
):
    """S row-batched sparse-option stages: the JAX leaf scan's body
    (``repro.core.mckp``'s ``leaf_scan``) run as a loop.

    dp0: [R, NB]; kb, vb: [S, R, K]; tmax: [R] integer or None.  Stage ``s``
    is :func:`maxplus_stage_batched` over ``kb[s], vb[s]``; its out is set
    to -inf where ``b > tmax[r]`` (when given) and feeds stage ``s + 1``.
    Returns (dp [R, NB] the last stage's masked out, wins [S, R, NB] int32
    each stage's arg).
    """
    if dp0.ndim != 2 or kb.ndim != 3 or kb.shape != vb.shape or kb.shape[1] != dp0.shape[0]:
        raise ValueError(
            f"bad shapes dp0={tuple(dp0.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)}"
        )
    if kb.shape[0] == 0:
        raise ValueError("a scan needs at least one stage")
    r, nb = dp0.shape
    over = None
    if tmax is not None:
        over = torch.arange(nb, device=dp0.device)[None, :] > tmax[:, None]
    dp = dp0
    wins = torch.empty((kb.shape[0], r, nb), dtype=torch.int32, device=dp0.device)
    for s in range(kb.shape[0]):
        out, wins[s] = maxplus_stage_batched(dp, kb[s], vb[s])
        dp = out if over is None else torch.where(over, -torch.inf, out)
    return dp, wins


# ---------------------------------------------------------------------------
# The serving path: RMSNorm and attention (repro/kernels/ref.py:56-126)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing axis, float32 statistics, the result in x's
    type: ``repro.kernels.ref.rmsnorm``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def mha_reference(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    *,
    causal: bool = True,
    window: int | None = None,
    logit_softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Grouped-query attention, float32 softmax: ``repro.kernels.ref.
    mha_reference``.  ``window`` lets each query see at most the previous
    ``window`` keys; ``q_offset`` places the queries at absolute positions
    [q_offset, q_offset + Tq) against keys [0, Tk)."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    groups = hq // hkv
    qf = q.to(torch.float32).reshape(b, tq, hkv, groups, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32)
    )
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    qpos = q_offset + torch.arange(tq, device=q.device)
    kpos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    logits = torch.where(mask, logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return out.reshape(b, tq, hq, d).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B, Hq, D] one new token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] valid KV lengths
    *,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token GQA decode with per-sequence lengths:
    ``repro.kernels.ref.decode_attention_reference``, plus the Pallas decode
    kernel's ``softcap`` and ``window`` (slot ``j`` is seen where
    ``lengths[b] - j <= window``)."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    groups = hq // hkv
    qf = q.to(torch.float32).reshape(b, hkv, groups, d)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, kf) / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32)
    )
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    length = lengths.to(q.device)[:, None]
    mask = pos < length  # [B, S]
    if window is not None:
        mask &= length - pos <= window
    logits = torch.where(mask[:, None, None, :], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return out.reshape(b, hq, d).to(q.dtype)
