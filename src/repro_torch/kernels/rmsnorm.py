"""CUDA launch of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.rmsnorm.rmsnorm``; its plain
version is :func:`repro_torch.kernels.ref.rmsnorm`.  The wrapper checks
device, type and shape, raises on what the kernel does not take, and adds
one to ``launches["rmsnorm"]`` per launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import aligned, check, launches, library

_ENTRY = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] bf16 or float32 and scale [d] on one CUDA device -> the
    normalised x in x's type; scale is used in float32."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"x/scale must lie on one CUDA device, got {x.device} {scale.device}")
    entry = _ENTRY.get(x.dtype)
    if entry is None:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    d = x.shape[-1]
    if x.ndim < 1 or scale.shape != (d,):
        raise ValueError(f"scale must be [{d}], got {tuple(scale.shape)}")
    rows = x.numel() // d if d else 0
    if not 0 < rows < 2**31 or not 0 < d < 2**31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    x2 = aligned(x.reshape(rows, d))
    s32 = aligned(scale.to(torch.float32))
    out = torch.empty_like(x2)
    lib = library("rmsnorm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x2.data_ptr(), s32.data_ptr(), out.data_ptr(), rows, d, eps, stream
        )
    check(lib, "rmsnorm", err)
    launches["rmsnorm"] += 1
    return out.reshape(x.shape)
