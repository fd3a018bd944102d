"""Build, loading and launch counts of the port's CUDA kernels.

Every kernel source lives under ``csrc/`` and replaces one or more Pallas
TPU kernels of ``repro/kernels/``.  Each is compiled for ``sm_90a`` by
``nvcc`` into its own shared library with a plain C interface and called
through ``ctypes``, at first use, into ``_build/`` beside this module
(listed in ``.gitignore``), keyed by the source's content hash; nothing is
built or loaded at import, so the CPU tests import this module freely.
:func:`build` starts one ``nvcc`` per source, all together.

Every C entry returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but 0.  Each wrapper adds one to its
counter in :data:`launches` where it launches its kernel, and nowhere
else, so a run can show that its path went through the kernel.
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

_CSRC = Path(__file__).parent / "csrc"

#: library name -> CUDA source
SOURCES = {
    "maxplus_conv": _CSRC / "maxplus_conv.cu",
    "maxplus_stage": _CSRC / "maxplus_stage.cu",
    "rmsnorm": _CSRC / "rmsnorm.cu",
    "flash_attention": _CSRC / "flash_attention.cu",
    "decode_attention": _CSRC / "decode_attention.cu",
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
    "maxplus_stages_batched": 0,
    "rmsnorm": 0,
    "flash_attention": 0,
    "decode_attention": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: library name -> (C entry -> argtypes), every entry returning int
_ENTRIES = {
    # dp, f, out, arg, workspace, rows, nb, stream; rows, nb, plan[2] (int64)
    "maxplus_conv": {
        "maxplus_conv_batched": [_P, _P, _P, _P, _P, _I, _I, _P],
        "maxplus_conv_plan": [_I, _I, _P],
    },
    # dp0, kb, vb, tmax, out, wins, ws, stages, rows, nb, k, stream; rows,
    # nb, itemsize, plan[3]
    "maxplus_stage": {
        "maxplus_stages_batched_f64": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "maxplus_stages_batched_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "maxplus_stages_plan": [_I, _I, _I, _P],
    },
    # x, scale (float32), out, rows, d, eps, stream
    "rmsnorm": {
        "rmsnorm_bf16": [_P, _P, _P, _I, _I, _F, _P],
        "rmsnorm_f32": [_P, _P, _P, _I, _I, _F, _P],
    },
    # q, k, v, out, b, sq, skv, hq, hkv, d, causal, window, softcap, scale,
    # stream
    "flash_attention": {
        "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
        "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    },
    # q, k_cache, v_cache, lengths (int32), out, b, s, hq, hkv, d, window,
    # softcap, stream
    "decode_attention": {
        "decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        "decode_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    },
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
    """Build output of source ``name``, keyed by the content hash of the
    source and of the shared headers under ``csrc/``."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


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


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if missing."""
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


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry of library ``name`` returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def call(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of CUDA device ``index``
    (the raw stream handle, read without building a ``torch.cuda.Stream``).
    The device is made current around the call only when it is not
    already (the kernels launch on the current device)."""
    c = torch._C
    if index == c._cuda_getDevice():
        return fn(*args, c._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, c._cuda_getCurrentRawStream(index))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the serving kernels' vector
    loads and TMA need: ``t`` itself when it already is, else a copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
