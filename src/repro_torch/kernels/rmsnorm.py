"""CUDA launch of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.rmsnorm.rmsnorm``; its plain
version is :func:`repro_torch.kernels.ref.rmsnorm`.  The wrapper checks
device, type and shape, raises on what the kernel does not take, and adds
one to ``launches["rmsnorm"]`` per launch.  It runs 81 times a forward of
the serving path, so its host work is kept to the checks, one output
allocation and the ctypes call on the raw stream handle: a copy of x or
scale is made only when x is not contiguous and 16-byte aligned, or scale
is not so or not float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import aligned, call, check, launches, library

_ENTRY = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] bf16 or float32 and scale [d] on one CUDA device -> the
    normalised x in x's type; scale is used in float32."""
    index = x.get_device()
    if index < 0 or scale.get_device() != index:
        raise ValueError(f"x/scale must lie on one CUDA device, got {x.device} {scale.device}")
    name = _ENTRY.get(x.dtype)
    if name is None:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    d = x.shape[-1] if x.ndim else 0
    if scale.ndim != 1 or scale.shape[0] != d:
        raise ValueError(f"scale must be [{d}], got {tuple(scale.shape)}")
    rows = x.numel() // d if d else 0
    if not 0 < rows < 2**31 or not 0 < d < 2**31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    x = aligned(x)
    if scale.dtype != torch.float32:
        scale = scale.to(torch.float32)
    scale = aligned(scale)
    out = torch.empty_like(x)
    lib = library("rmsnorm")
    err = call(index, getattr(lib, name), x.data_ptr(), scale.data_ptr(), out.data_ptr(),
               rows, d, eps)
    check(lib, "rmsnorm", err)
    launches["rmsnorm"] += 1
    return out
