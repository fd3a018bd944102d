"""Public wrappers of the (max,+) DP stage.

A CUDA tensor launches the hand-written kernel (``mckp_dp``) or raises; a
CPU tensor takes the plain PyTorch version (``ref``).  Nothing else picks
the route, and nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import mckp_dp as _mckp_dp
from repro_torch.kernels import ref as _ref


def maxplus_conv(dp: torch.Tensor, f: torch.Tensor):
    """(max,+)-convolution DP stage over [NB] float32.  Returns (out, arg)."""
    if dp.is_cuda:
        return _mckp_dp.maxplus_conv(dp, f)
    return _ref.maxplus_conv(dp, f)


def maxplus_conv_batched(dp: torch.Tensor, f: torch.Tensor):
    """Row-batched stage: dp, f [R, NB] float32, one launch for R rows;
    each row is bitwise what :func:`maxplus_conv` computes for it alone."""
    if dp.is_cuda:
        return _mckp_dp.maxplus_conv_batched(dp, f)
    return _ref.maxplus_conv_batched(dp, f)


def maxplus_scan_batched(f_groups: torch.Tensor, stage_gids: torch.Tensor):
    """Repeated-stage (max,+) DP scan over L independent rows.

    f_groups: [L, G, NB] per-row class curve banks; stage_gids: [L, N]
    class ids, one per stage.  Stage ``i`` gathers each row's curve and
    runs one row-batched convolution, starting from ``dp = 0``.  Returns
    (dp_final [L, NB], arg [L, N, NB]), all on ``f_groups``' device.
    """
    n_rows, _, nb = f_groups.shape
    rows = torch.arange(n_rows, device=f_groups.device)
    dp = torch.zeros((n_rows, nb), dtype=f_groups.dtype, device=f_groups.device)
    args = []
    for i in range(stage_gids.shape[1]):
        dp, arg = maxplus_conv_batched(dp, f_groups[rows, stage_gids[:, i]])
        args.append(arg)
    return dp, torch.stack(args, dim=1)


def maxplus_scan(f_groups: torch.Tensor, stage_gids: torch.Tensor):
    """Single-row scan: f_groups [G, NB], stage_gids [N].  Returns
    (dp_final [NB], arg [N, NB]) through :func:`maxplus_scan_batched`."""
    dp, args = maxplus_scan_batched(f_groups[None], stage_gids[None])
    return dp[0], args[0]
