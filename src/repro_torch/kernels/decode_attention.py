"""CUDA launch of the flash-decode kernel (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``; its plain version is
:func:`repro_torch.kernels.ref.decode_attention_reference`.  The wrapper
checks device, type and shape, raises on what the kernel does not take,
and adds one to ``launches["decode_attention"]`` per launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import aligned, call, check, launches, library

_ENTRY = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}
MAX_GROUP = 16  # query heads per KV head
MAX_GROUP_DIM = 2048  # group * head dim


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid KV lengths
    *,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """One-token GQA attention over the cache slots ``j < lengths[b]``
    (and ``lengths[b] - j <= window``).  Returns [B, Hq, D] in q's type."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"bad shapes q={tuple(q.shape)} k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}"
        )
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k_cache.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    index = q.get_device()
    if index < 0 or any(t.get_device() != index for t in (k_cache, v_cache, lengths)):
        raise ValueError(f"q/cache/lengths must lie on one CUDA device, got {q.device}")
    name = _ENTRY.get(q.dtype)
    if name is None or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"q/cache must share bfloat16 or float32, got {q.dtype} {k_cache.dtype}"
        )
    group = hq // hkv
    if d % 8 or group > MAX_GROUP or group * d > MAX_GROUP_DIM:
        raise ValueError(
            f"unsupported head dim {d} or group {group} (d % 8 == 0, group <= "
            f"{MAX_GROUP}, group * d <= {MAX_GROUP_DIM})"
        )
    if not (0 < b <= 65535 and 0 < hkv <= 65535 and 0 < s < 2**31):
        raise ValueError(f"unsupported shape k={tuple(k_cache.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k_cache, v_cache = aligned(q), aligned(k_cache), aligned(v_cache)
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = library("decode_attention")
    err = call(
        index, getattr(lib, name), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, s, hq, hkv, d, window or 0,
        softcap or 0.0,
    )
    check(lib, "decode_attention", err)
    launches["decode_attention"] += 1
    return out
