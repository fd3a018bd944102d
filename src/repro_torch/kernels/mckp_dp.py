"""CUDA build, binding and launch of the (max,+) DP stage kernels.

Two sources under ``csrc/``, each replacing Pallas TPU kernels of
``repro/kernels/mckp_dp.py``:

 * ``maxplus_conv.cu`` — the dense (max,+) convolution
   (``maxplus_conv_pallas_batched`` and ``maxplus_conv_pallas``), float32;
 * ``maxplus_stage.cu`` — the sparse-option stage with a first-max
   backpointer (``maxplus_stage_pallas_batched``), float64 or float32:
   ``maxplus_stages_batched`` runs all S stages of the fused round's leaf
   scan in one cooperative launch over the card (a grid barrier between
   stages, the dp row staged in shared memory), and
   ``maxplus_stage_batched`` is its S = 1 launch.

The build, the loading and the launch counts live in :mod:`build`
(re-exported here); each wrapper adds one to its counter in
:data:`launches` per kernel launch, and nowhere else.  Both launch through
:func:`build.call`, which reads the raw stream and switches the device
only when it is not current.

The dense kernel merges its work items through a workspace of keys and
counters (``csrc/maxplus_conv.cu``).  The wrapper allocates it for each
call and the C entry zeroes it on the stream before the launch, so the
caching allocator orders its reuse across streams and a CUDA graph
captures it with the launch.  The multi-stage launch ping-pongs its
stages between ``out`` and a workspace row of the same shape, allocated
for each call.
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


_STAGE_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


@functools.lru_cache(maxsize=256)
def stages_plan(index: int, rows: int, nb: int, itemsize: int) -> tuple[int, int, int]:
    """(resident route, grid blocks, dynamic shared memory bytes) of a stage
    launch over [rows, nb] on CUDA device ``index``, from the C entry that
    plans every launch (builds the kernel)."""
    lib = library("maxplus_stage")
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        check(lib, "maxplus_stage", lib.maxplus_stages_plan(rows, nb, itemsize, plan))
    return plan[0], plan[1], plan[2]


def _stages_launch(dp0, kb, vb, tmax, counter: str):
    """One launch of the stage kernel over dp0 [R, NB], kb, vb [S, R, K],
    tmax [R] or None (shapes checked by the callers); raises on what the
    kernel does not take."""
    index = dp0.get_device()
    if index < 0 or kb.get_device() != index or vb.get_device() != index or (
        tmax is not None and tmax.get_device() != index
    ):
        raise ValueError(
            f"dp/kb/vb/tmax must lie on one CUDA device, got {dp0.device} {kb.device} "
            f"{vb.device} {None if tmax is None else tmax.device}"
        )
    suffix = _STAGE_SUFFIX.get(dp0.dtype)
    if suffix is None or vb.dtype != dp0.dtype or kb.dtype != torch.int32 or (
        tmax is not None and tmax.dtype != torch.int32
    ):
        raise TypeError(
            f"dp/vb must share float64 or float32 and kb, tmax be int32, got "
            f"{dp0.dtype} {vb.dtype} {kb.dtype} {None if tmax is None else tmax.dtype}"
        )
    stages, rows, k = kb.shape
    nb = dp0.shape[1]
    if not 0 < rows <= 65535 or not 0 < nb < 2**31 or not 0 < k < 2**31 or stages >= 2**31:
        raise ValueError(f"unsupported shape dp={tuple(dp0.shape)} kb={tuple(kb.shape)}")
    dp0 = dp0.contiguous()
    kb = kb.contiguous()
    vb = vb.contiguous()
    tmax = None if tmax is None else tmax.contiguous()
    out = torch.empty_like(dp0)
    wins = torch.empty((stages, rows, nb), dtype=torch.int32, device=dp0.device)
    ws = None if stages == 1 else torch.empty_like(dp0)
    lib = library("maxplus_stage")
    err = call(
        index, getattr(lib, f"maxplus_stages_batched_{suffix}"), dp0.data_ptr(),
        kb.data_ptr(), vb.data_ptr(), None if tmax is None else tmax.data_ptr(),
        out.data_ptr(), wins.data_ptr(), None if ws is None else ws.data_ptr(),
        stages, rows, nb, k,
    )
    check(lib, "maxplus_stage", err)
    launches[counter] += 1
    return out, wins


def maxplus_stage_batched(dp: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """Sparse-option stage kernel: dp [R, NB], kb [R, K] int32 and vb [R, K]
    of dp's type (float64 or float32), all on one CUDA device ->
    (out [R, NB], arg [R, NB] int32).  The S = 1, unmasked launch of the
    multi-stage kernel."""
    if dp.ndim != 2 or kb.ndim != 2 or kb.shape != vb.shape or kb.shape[0] != dp.shape[0]:
        raise ValueError(
            f"bad shapes dp={tuple(dp.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)}"
        )
    out, wins = _stages_launch(dp, kb[None], vb[None], None, "maxplus_stage_batched")
    return out, wins[0]


def maxplus_stages_batched(
    dp0: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, tmax: torch.Tensor | None = None
):
    """S sparse-option stages in one launch: dp0 [R, NB], kb [S, R, K] int32,
    vb [S, R, K] of dp0's type (float64 or float32), tmax [R] int32 or None,
    all on one CUDA device -> (dp [R, NB], wins [S, R, NB] int32).  Each
    stage's out is set to -inf where b > tmax[r] (when given) and feeds the
    next; wins[s] is stage s's first-max arg."""
    if (
        dp0.ndim != 2 or kb.ndim != 3 or kb.shape != vb.shape
        or kb.shape[1] != dp0.shape[0] or kb.shape[0] == 0
        or (tmax is not None and tuple(tmax.shape) != (dp0.shape[0],))
    ):
        raise ValueError(
            f"bad shapes dp0={tuple(dp0.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)} "
            f"tmax={None if tmax is None else tuple(tmax.shape)}"
        )
    return _stages_launch(dp0, kb, vb, tmax, "maxplus_stages_batched")
