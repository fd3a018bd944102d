"""CUDA launch of the prefill flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``; its plain version is
:func:`repro_torch.kernels.ref.mha_reference`.  bfloat16 runs
``flash_attention_wgmma_kernel`` (tensor cores: wgmma, with K/V fed by
TMA), float32 runs ``flash_attention_simt_kernel`` (CUDA cores, full
float32).  The wrapper checks device, type and shape, raises on what the
kernel does not take, and adds one to ``launches["flash_attention"]`` per
launch.

Head dims.  The kernels are instantiated at ``HEAD_DIMS``; any other head
dim up to 128 (80: zamba2-2.7b, hubert-xlarge) runs the next instantiated
one with q, k and v zero-padded to it and the true scale ``1/sqrt(d)``
passed to the kernel.  The zero columns add exact zeros to every q . k, and
the padded columns of V only fill output columns that are sliced away, so
the result is the function the JAX package computes at head dim d.  Padding
was chosen over a wgmma instantiation at D = 80: a 160-byte row fits no
single 128-byte-swizzle TMA box, so that kernel would need a new tile
layout and new wgmma descriptors, while padding reuses the D = 128 kernels
as they are checked.  Its price is one padded copy of q, k and v a call and
128/80 of the D-proportional work; ``chip_smoke.py`` times both at
zamba2's and hubert's shapes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import aligned, call, check, launches, library

_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)


def kernel_head_dim(d: int) -> int:
    """The instantiated head dim that runs head dim ``d``: the smallest of
    ``HEAD_DIMS`` that is at least ``d``."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"head dim {d} above the largest instantiated one, {HEAD_DIMS[-1]}")


def pad_head_dim(x: torch.Tensor, dk: int) -> torch.Tensor:
    """``x`` [..., d] zero-padded to [..., dk] (``x`` itself when d == dk)."""
    d = x.shape[-1]
    return x if d == dk else F.pad(x, (0, dk - d))


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """GQA attention on the card: query head ``h`` reads KV head
    ``h // (Hq // Hkv)``.  Returns [B, Sq, Hq, D] in q's type."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    index = q.get_device()
    if index < 0 or k.get_device() != index or v.get_device() != index:
        raise ValueError(f"q/k/v must lie on one CUDA device, got {q.device} {k.device}")
    name = _ENTRY.get(q.dtype)
    if name is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share bfloat16 or float32, got {q.dtype} {k.dtype}")
    if d < 1:
        raise ValueError(f"head dim must be >= 1, got {d}")
    dk = kernel_head_dim(d)
    if not (0 < b <= 65535 and 0 < hq <= 65535 and 0 < sq and 0 < skv):
        raise ValueError(f"unsupported shape q={tuple(q.shape)} k={tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = (aligned(pad_head_dim(t, dk)) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = library("flash_attention")
    err = call(
        index, getattr(lib, name), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, skv, hq, hkv, dk, int(causal), window or 0, softcap or 0.0,
        1.0 / math.sqrt(d),
    )
    check(lib, "flash_attention", err)
    launches["flash_attention"] += 1
    return out if dk == d else out[..., :d]
