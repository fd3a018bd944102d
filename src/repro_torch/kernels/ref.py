"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic ground truth its CUDA kernel is held
against on the card and the path a kernel wrapper takes for CPU tensors;
the dense convolution is also the ``"jax"`` backend of the dense solvers
(the name is kept from the JAX package, where it selects the pure-jnp
path).
"""

from __future__ import annotations

import torch


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor, chunk: int = 512):
    """Row-batched tropical-semiring convolution.

    dp, f: [R, NB].  ``out[r, b] = max_{0<=k<=b} dp[r, b-k] + f[r, k]`` and
    ``arg[r, b]`` is the smallest maximizing ``k`` (int32), exactly
    ``repro.kernels.ref.maxplus_conv`` on each row.  Evaluated in b-chunks
    so the [R, chunk, NB] candidate tile bounds the memory footprint.
    """
    if dp.ndim != 2 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-shape 2D, got {dp.shape} {f.shape}")
    r, nb = dp.shape
    # left pad NB entries of -inf: index NB + b - k is in-bounds for every
    # k <= NB - 1 and reads -inf exactly where b - k < 0
    dp_pad = torch.cat([torch.full_like(dp, -torch.inf), dp], dim=1)
    ks = torch.arange(nb, device=dp.device)
    out = torch.empty_like(dp)
    arg = torch.empty((r, nb), dtype=torch.int32, device=dp.device)
    for b0 in range(0, nb, chunk):
        b = torch.arange(b0, min(b0 + chunk, nb), device=dp.device)
        cand = dp_pad[:, nb + b[:, None] - ks[None, :]] + f[:, None, :]
        a = cand.argmax(dim=2)  # first maximal index: the smallest k
        out[:, b0 : b0 + len(b)] = cand.gather(2, a[..., None])[..., 0]
        arg[:, b0 : b0 + len(b)] = a.to(torch.int32)
    return out, arg


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor, chunk: int = 512):
    """Single-row form of :func:`maxplus_conv_batched`: dp, f: [NB]."""
    if dp.ndim != 1 or dp.shape != f.shape:
        raise ValueError(f"dp/f must be equal-length 1D, got {dp.shape} {f.shape}")
    out, arg = maxplus_conv_batched(dp[None], f[None], chunk)
    return out[0], arg[0]


def maxplus_stage_batched(
    dp: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, chunk_elems: int = 1 << 22
):
    """Row-batched sparse-option (max,+) stage with a first-max backpointer.

    dp: [R, NB]; kb: [R, K] integer spend offsets; vb: [R, K] option values
    of dp's type.  ``out[r, b] = max_j dp[r, b - kb[r, j]] + vb[r, j]`` with
    ``dp[r, i]`` read as -inf for ``i`` outside ``[0, NB)``, and ``arg[r, b]``
    the first maximizing ``j`` (int32; 0 where every candidate is -inf) —
    ``repro.kernels.mckp_dp.maxplus_stage_pallas_batched`` row by row, in
    the input type.  Evaluated in b-chunks of an [R, K, chunk] candidate
    tile; ``argmax`` over ``j`` returns the first maximal index.
    """
    if dp.ndim != 2 or kb.ndim != 2 or kb.shape != vb.shape or kb.shape[0] != dp.shape[0]:
        raise ValueError(
            f"bad shapes dp={tuple(dp.shape)} kb={tuple(kb.shape)} vb={tuple(vb.shape)}"
        )
    if vb.dtype != dp.dtype:
        raise TypeError(f"vb must have dp's type {dp.dtype}, got {vb.dtype}")
    r, nb = dp.shape
    k = kb.shape[1]
    if k == 0:
        raise ValueError("a stage needs at least one option")
    kb64 = kb.to(torch.int64)
    rows = torch.arange(r, device=dp.device)[:, None, None]
    out = torch.empty_like(dp)
    arg = torch.empty((r, nb), dtype=torch.int32, device=dp.device)
    chunk = max(1, chunk_elems // (r * k))
    for b0 in range(0, nb, chunk):
        b = torch.arange(b0, min(b0 + chunk, nb), device=dp.device)
        idx = b[None, None, :] - kb64[:, :, None]  # [R, K, chunk]
        x = dp[rows, idx.clamp(0, nb - 1)]
        x = torch.where((idx >= 0) & (idx < nb), x, -torch.inf)
        cand = x + vb[:, :, None]
        a = cand.argmax(dim=1)  # first maximal j
        out[:, b0 : b0 + len(b)] = cand.gather(1, a[:, None, :])[:, 0, :]
        arg[:, b0 : b0 + len(b)] = a.to(torch.int32)
    return out, arg
