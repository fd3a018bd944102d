"""Public wrappers of the port's kernels: the (max,+) DP stages, the fused
round's bank compaction, and the serving path's RMSNorm, prefill attention
and decode attention.

A CUDA tensor launches the hand-written kernel (``mckp_dp``, ``rmsnorm``,
``flash_attention``, ``decode_attention``) or raises; a CPU tensor takes
the plain PyTorch version (``ref``).  Nothing else picks
the route, and nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mckp_dp as _mckp_dp
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rmsnorm


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor):
    """(max,+)-convolution DP stage over [NB] float32.  Returns (out, arg)."""
    if dp.is_cuda:
        return _mckp_dp.maxplus_conv(dp, f)
    return _ref.maxplus_conv(dp, f)


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor):
    """Row-batched stage: dp, f [R, NB] float32, one launch for R rows;
    each row is bitwise what :func:`maxplus_conv` computes for it alone."""
    if dp.is_cuda:
        return _mckp_dp.maxplus_conv_batched(dp, f)
    return _ref.maxplus_conv_batched(dp, f)


def maxplus_stage_batched(dp: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """Sparse-option (max,+) stage with a first-max backpointer: dp [R, NB],
    kb [R, K] int32, vb [R, K] of dp's type (float64 in the fused round).
    Returns (out [R, NB], arg [R, NB] int32)."""
    if dp.is_cuda:
        return _mckp_dp.maxplus_stage_batched(dp, kb, vb)
    return _ref.maxplus_stage_batched(dp, kb, vb)


def maxplus_stages_batched(dp0, kb, vb, tmax=None):
    """S sparse-option stages, the fused round's leaf scan: dp0 [R, NB],
    kb [S, R, K] int32, vb [S, R, K] of dp0's type, tmax [R] int32 or None
    (each stage's out set to -inf where b > tmax[r]).  One kernel launch on
    the card.  Returns (dp [R, NB], wins [S, R, NB] int32)."""
    if dp0.is_cuda:
        return _mckp_dp.maxplus_stages_batched(dp0, kb, vb, tmax)
    return _ref.maxplus_stages_batched(dp0, kb, vb, tmax)


def bank_compact(kb_old, vb_old, src_s, src_l, *, k_pad: int):
    """Repack the fused round's resident option banks into a new layout.

    ``src_s``/``src_l`` are ``[S_new, L_new]`` integer gather maps into the
    old ``[S_old, L_old, K_old]`` banks; -1 marks a row with no clean
    source, which becomes the identity row ``kb = 0 / vb = [0, -inf, ...]``
    (the caller scatters its content afterwards).  The option axis pads
    with identity options or truncates to ``k_pad``; a clean row's tail
    beyond its own options is identity padding, so both are exact.  A plain
    gather and select on the banks' device (``repro.kernels.ops.bank_compact``
    is a jnp op, not a Pallas kernel): no value is recomputed, so a
    gathered row is bitwise the row a host rebuild would upload.
    """
    valid = src_s >= 0
    ss = torch.where(valid, src_s, 0).long()
    ll = torch.where(valid, src_l, 0).long()
    kb_g = kb_old[ss, ll]  # [S_new, L_new, K_old]
    vb_g = vb_old[ss, ll]
    k_old = kb_old.shape[-1]
    if k_pad > k_old:
        kb_g = torch.nn.functional.pad(kb_g, (0, k_pad - k_old))
        vb_g = torch.nn.functional.pad(vb_g, (0, k_pad - k_old), value=-torch.inf)
    elif k_pad < k_old:
        kb_g = kb_g[..., :k_pad]
        vb_g = vb_g[..., :k_pad]
    vb_id = torch.full_like(vb_g, -torch.inf)
    vb_id[..., 0] = 0.0
    m = valid[..., None]
    return (
        torch.where(m, kb_g, torch.zeros_like(kb_g)).contiguous(),
        torch.where(m, vb_g, vb_id).contiguous(),
    )


def maxplus_scan_batched(f_groups: torch.Tensor, stage_gids: torch.Tensor):
    """Repeated-stage (max,+) DP scan over L independent rows.

    f_groups: [L, G, NB] per-row class curve banks; stage_gids: [L, N]
    class ids, one per stage.  Stage ``i`` gathers each row's curve and
    runs one row-batched convolution, starting from ``dp = 0``.  Returns
    (dp_final [L, NB], arg [L, N, NB]), all on ``f_groups``' device.
    """
    n_rows, _, nb = f_groups.shape
    rows = torch.arange(n_rows, device=f_groups.device)
    dp = torch.zeros((n_rows, nb), dtype=f_groups.dtype, device=f_groups.device)
    args = []
    for i in range(stage_gids.shape[1]):
        dp, arg = maxplus_conv_batched(dp, f_groups[rows, stage_gids[:, i]])
        args.append(arg)
    return dp, torch.stack(args, dim=1)


def maxplus_scan(f_groups: torch.Tensor, stage_gids: torch.Tensor):
    """Single-row scan: f_groups [G, NB], stage_gids [N].  Returns
    (dp_final [NB], arg [N, NB]) through :func:`maxplus_scan_batched`."""
    dp, args = maxplus_scan_batched(f_groups[None], stage_gids[None])
    return dp[0], args[0]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm over the trailing axis (float32 statistics, the result
    in x's type)."""
    if x.is_cuda:
        return _rmsnorm.rmsnorm(x, scale, eps=eps)
    return _ref.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """GQA attention for prefill: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]."""
    if q.is_cuda:
        return _flash.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    return _ref.mha_reference(q, k, v, causal=causal, window=window, logit_softcap=softcap)


def decode_attention(q, k_cache, v_cache, lengths, *, softcap=None, window=None):
    """Flash-decode GQA attention of one token per sequence over a KV cache
    [B, S, Hkv, D] with per-sequence ``lengths``."""
    if q.is_cuda:
        return _decode.decode_attention(
            q, k_cache, v_cache, lengths, softcap=softcap, window=window
        )
    return _ref.decode_attention_reference(
        q, k_cache, v_cache, lengths, softcap=softcap, window=window
    )
