"""CUDA build, binding and launch of the (max,+) DP stage kernels.

Two sources under ``csrc/``, each replacing Pallas TPU kernels of
``repro/kernels/mckp_dp.py``:

 * ``maxplus_conv.cu`` — the dense (max,+) convolution
   (``maxplus_conv_pallas_batched`` and ``maxplus_conv_pallas``), float32;
 * ``maxplus_stage.cu`` — the sparse-option stage with a first-max
   backpointer (``maxplus_stage_pallas_batched``), float64 or float32.

The build, the loading and the launch counts live in :mod:`build`
(re-exported here); each wrapper adds one to its counter in
:data:`launches` per kernel launch, and nowhere else.  Both launch through
:func:`build.call`, which reads the raw stream and switches the device
only when it is not current.

The dense kernel merges its work items through a workspace of keys and
counters (``csrc/maxplus_conv.cu``).  The wrapper allocates it for each
call and the C entry zeroes it on the stream before the launch, so the
caching allocator orders its reuse across streams and a CUDA graph
captures it with the launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (  # noqa: F401  (re-exported)
    BUILD_DIR,
    NVCC_FLAGS,
    SOURCES,
    build,
    call,
    check,
    launches,
    library,
    library_path,
    reset_launches,
)


@functools.lru_cache(maxsize=64)
def _plan(rows: int, nb: int) -> tuple[int, int]:
    """(workspace bytes, work items) of a dense launch over [rows, nb], from
    the C entry that sizes the launch."""
    lib = library("maxplus_conv")
    plan = (ctypes.c_longlong * 2)()
    check(lib, "maxplus_conv", lib.maxplus_conv_plan(rows, nb, plan))
    return plan[0], plan[1]


def work_items(rows: int, nb: int) -> int:
    """Work items of one dense launch over [rows, nb] (builds the kernel)."""
    return _plan(rows, nb)[1]


def _launch(dp: torch.Tensor, f: torch.Tensor, counter: str):
    """One dense-convolution launch over float32 CUDA tensors of one shape,
    [R, NB] or a single row [NB] (no view is made of it: host time)."""
    index = dp.get_device()
    if index < 0 or f.get_device() != index:
        raise ValueError(f"dp/f must lie on one CUDA device, got {dp.device} {f.device}")
    if dp.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"dp/f must be float32, got {dp.dtype} {f.dtype}")
    rows, nb = dp.shape if dp.ndim == 2 else (1, dp.shape[0])
    if not 0 < rows <= 65535 or not 0 < nb <= 65535 * 256:  # grid limits of the kernel
        raise ValueError(f"unsupported shape {tuple(dp.shape)}")
    dp = dp.contiguous()
    f = f.contiguous()
    out = torch.empty_like(dp)
    arg = torch.empty(dp.shape, dtype=torch.int32, device=dp.device)
    lib = library("maxplus_conv")
    ws = torch.empty((_plan(rows, nb)[0] + 7) // 8, dtype=torch.int64, device=dp.device)
    err = call(
        index, lib.maxplus_conv_batched, dp.data_ptr(), f.data_ptr(), out.data_ptr(),
        arg.data_ptr(), ws.data_ptr(), rows, nb,
    )
    check(lib, "maxplus_conv", err)
    launches[counter] += 1
    return out, arg


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor):
    """Row-batched kernel: dp, f [R, NB] float32 on CUDA -> (out, arg)."""
    if dp.ndim != 2 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-shape 2D, got {dp.shape} {f.shape}")
    return _launch(dp, f, "maxplus_conv_batched")


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor):
    """Single-row kernel: the R = 1 launch of the batched kernel."""
    if dp.ndim != 1 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-length 1D, got {dp.shape} {f.shape}")
    return _launch(dp, f, "maxplus_conv")


_STAGE_ENTRY = {
    torch.float64: "maxplus_stage_batched_f64",
    torch.float32: "maxplus_stage_batched_f32",
}


def maxplus_stage_batched(dp: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """Sparse-option stage kernel: dp [R, NB], kb [R, K] int32 and vb [R, K]
    of dp's type (float64 or float32), all on one CUDA device ->
    (out [R, NB], arg [R, NB] int32)."""
    if dp.ndim != 2 or kb.ndim != 2 or kb.shape != vb.shape or kb.shape[0] != dp.shape[0]:
        raise ValueError(
            f"bad shapes dp={tuple(dp.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)}"
        )
    index = dp.get_device()
    if index < 0 or kb.get_device() != index or vb.get_device() != index:
        raise ValueError(
            f"dp/kb/vb must lie on one CUDA device, got {dp.device} {kb.device} {vb.device}"
        )
    entry = _STAGE_ENTRY.get(dp.dtype)
    if entry is None or vb.dtype != dp.dtype or kb.dtype != torch.int32:
        raise TypeError(
            f"dp/vb must share float64 or float32 and kb be int32, got "
            f"{dp.dtype} {vb.dtype} {kb.dtype}"
        )
    rows, nb = dp.shape
    k = kb.shape[1]
    if not 0 < rows <= 65535 or not 0 < nb < 2**31 or not 0 < k < 2**31:
        raise ValueError(f"unsupported shape dp={tuple(dp.shape)} kb={tuple(kb.shape)}")
    dp = dp.contiguous()
    kb = kb.contiguous()
    vb = vb.contiguous()
    out = torch.empty_like(dp)
    arg = torch.empty((rows, nb), dtype=torch.int32, device=dp.device)
    lib = library("maxplus_stage")
    err = call(
        index, getattr(lib, entry), dp.data_ptr(), kb.data_ptr(), vb.data_ptr(),
        out.data_ptr(), arg.data_ptr(), rows, nb, k,
    )
    check(lib, "maxplus_stage", err)
    launches["maxplus_stage_batched"] += 1
    return out, arg
