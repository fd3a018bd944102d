"""CUDA build, binding and launch of the dense (max,+) DP stage kernel.

``csrc/maxplus_conv.cu`` replaces the Pallas TPU kernels
``maxplus_conv_pallas_batched`` and ``maxplus_conv_pallas``
(``repro/kernels/mckp_dp.py``).  It is compiled for ``sm_90a`` by ``nvcc``
into a shared library with a plain C interface and called through
``ctypes``, at first use, into ``_build/`` beside this module (listed in
``.gitignore``); nothing is built or loaded at import, so the CPU tests
import this module freely.

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

SOURCE = Path(__file__).parent / "csrc" / "maxplus_conv.cu"
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
launches: dict[str, int] = {"maxplus_conv": 0, "maxplus_conv_batched": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return nvcc


def library_path() -> Path:
    """Build output for the current source (keyed by its content hash)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmaxplus_conv-{digest}.so"


def build() -> str:
    """Compile the kernel library; returns nvcc's output (the ``-Xptxas -v``
    register/shared-memory summary).  Writes to a temporary file first and
    renames it into place, so concurrent builders never load a torn file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = library_path()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        lib.maxplus_conv_batched.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.maxplus_conv_batched.restype = ctypes.c_int
        lib.maxplus_conv_error_string.argtypes = [ctypes.c_int]
        lib.maxplus_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(dp: torch.Tensor, f: torch.Tensor, counter: str):
    """One kernel launch over [R, NB] float32 CUDA tensors."""
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
    lib = _library()
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = lib.maxplus_conv_batched(
            dp.data_ptr(), f.data_ptr(), out.data_ptr(), arg.data_ptr(),
            rows, nb, stream,
        )
    if err != 0:
        msg = lib.maxplus_conv_error_string(err).decode()
        raise RuntimeError(f"maxplus_conv launch failed: {msg} ({err})")
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
