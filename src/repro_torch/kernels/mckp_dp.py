"""CUDA build, binding and launch of the (max,+) DP stage kernels.

Two sources under ``csrc/``, each replacing Pallas TPU kernels of
``repro/kernels/mckp_dp.py``:

 * ``maxplus_conv.cu`` — the dense (max,+) convolution
   (``maxplus_conv_pallas_batched`` and ``maxplus_conv_pallas``), float32;
 * ``maxplus_stage.cu`` — the sparse-option stage with a first-max
   backpointer (``maxplus_stage_pallas_batched``), float64 or float32.

Each is compiled for ``sm_90a`` by ``nvcc`` into its own shared library
with a plain C interface and called through ``ctypes``, at first use, into
``_build/`` beside this module (listed in ``.gitignore``), keyed by the
source's content hash; nothing is built or loaded at import, so the CPU
tests import this module freely.  :func:`build` starts one ``nvcc`` per
source, all together.

Each wrapper counts its launches in :data:`launches` (one per kernel
launch, nowhere else), so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

#: library name -> CUDA source
SOURCES = {
    "maxplus_conv": Path(__file__).parent / "csrc" / "maxplus_conv.cu",
    "maxplus_stage": Path(__file__).parent / "csrc" / "maxplus_stage.cu",
}
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: wrapper name -> kernel launches since the last reset
launches: dict[str, int] = {
    "maxplus_conv": 0,
    "maxplus_conv_batched": 0,
    "maxplus_stage_batched": 0,
}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    """Build output of source ``name`` (keyed by its content hash)."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compile the kernel libraries ``names`` (default: all), one ``nvcc``
    per source, started together.  Returns name -> nvcc's output (the
    ``-Xptxas -v`` register/shared-memory summary).  Each writes to a
    temporary file first and is renamed into place, so concurrent builds
    never load a torn file."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name in names:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            jobs[name] = (proc, tmp)
        logs = {}
        for name, (proc, tmp) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{out}"
                )
            os.replace(tmp, library_path(name))
            logs[name] = out
        return logs
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


_P = ctypes.c_void_p
_I = ctypes.c_int
#: library name -> (C entry -> argtypes), every entry returning int
_ENTRIES = {
    "maxplus_conv": {"maxplus_conv_batched": [_P, _P, _P, _P, _I, _I, _P]},
    "maxplus_stage": {
        "maxplus_stage_batched_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "maxplus_stage_batched_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _check(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _launch(dp: torch.Tensor, f: torch.Tensor, counter: str):
    """One dense-convolution launch over [R, NB] float32 CUDA tensors."""
    if dp.ndim != 2 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-shape 2D, got {dp.shape} {f.shape}")
    if dp.device.type != "cuda" or f.device != dp.device:
        raise ValueError(f"dp/f must lie on one CUDA device, got {dp.device} {f.device}")
    if dp.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"dp/f must be float32, got {dp.dtype} {f.dtype}")
    rows, nb = dp.shape
    if not 0 < rows <= 65535 or not 0 < nb < 2**31:
        raise ValueError(f"unsupported shape {tuple(dp.shape)}")
    dp = dp.contiguous()
    f = f.contiguous()
    out = torch.empty_like(dp)
    arg = torch.empty((rows, nb), dtype=torch.int32, device=dp.device)
    lib = _library("maxplus_conv")
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = lib.maxplus_conv_batched(
            dp.data_ptr(), f.data_ptr(), out.data_ptr(), arg.data_ptr(),
            rows, nb, stream,
        )
    _check(lib, "maxplus_conv", err)
    launches[counter] += 1
    return out, arg


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor):
    """Row-batched kernel: dp, f [R, NB] float32 on CUDA -> (out, arg)."""
    return _launch(dp, f, "maxplus_conv_batched")


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor):
    """Single-row kernel: the R = 1 launch of the batched kernel."""
    if dp.ndim != 1 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-length 1D, got {dp.shape} {f.shape}")
    out, arg = _launch(dp[None], f[None], "maxplus_conv")
    return out[0], arg[0]


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
    if dp.device.type != "cuda" or kb.device != dp.device or vb.device != dp.device:
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
    lib = _library("maxplus_stage")
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = getattr(lib, entry)(
            dp.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
            arg.data_ptr(), rows, nb, k, stream,
        )
    _check(lib, "maxplus_stage", err)
    launches["maxplus_stage_batched"] += 1
    return out, arg
