"""The layer stack and its KV caches: the serving path's part of
``repro.models.transformer``.

The reference scans ``scan_unit``-sized pattern units over stacked
parameters (``lax.scan``) and runs a tail unscanned.  The port keeps one
module per layer in an ``nn.ModuleList``, in the reference's layer order
(unit 0's layers, unit 1's, ..., then the tail), and loops over it; layer
``i`` owns the parameters the reference keeps at index ``i // len(unit)``
of its stacked unit leaf (``repro_torch.interop`` moves them across).

Layer kinds ``attn`` and ``attn_local`` are ported.  The other kinds and
mixture-of-experts FFNs raise ``NotImplementedError`` naming their
ROADMAP.md item.

The KV cache is a flat dict of tensors, ``layers.{i}.k`` / ``layers.{i}.v``
[B, S_cache, Hkv, hd] in the compute dtype; sliding-window layers keep a
ring of ``min(window, s_max)`` slots.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

ATTN_KINDS = ("attn", "attn_local")
#: unported layer kind -> its ROADMAP.md item
UNPORTED_KINDS = {
    "attn_cross": "ROADMAP.md §1 item 7 (cross-attention layers, with the vlm frontend)",
    "mamba": "ROADMAP.md §1 item 7 (mamba2 layers)",
    "mamba_shared_attn": "ROADMAP.md §1 item 7 (mamba2 layers with zamba2's shared attention)",
    "mlstm": "ROADMAP.md §1 item 7 (xLSTM layers)",
    "slstm": "ROADMAP.md §1 item 7 (xLSTM layers)",
}


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose stack holds an
    unported layer kind or a mixture-of-experts FFN."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts FFNs are not ported yet "
            "(ROADMAP.md §1 item 7, models/moe.py)"
        )
    for kind in dict.fromkeys(cfg.layer_kinds()):
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet ({UNPORTED_KINDS[kind]})"
            )


def layer_window(kind: str, cfg: ArchConfig) -> int | None:
    return cfg.sliding_window if kind == "attn_local" else None


class Layer(nn.Module):
    """One pre-norm attention layer: ``init_layer`` for kinds ``attn`` and
    ``attn_local``."""

    def __init__(self, kind: str, cfg: ArchConfig, device=None):
        super().__init__()
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"layer kind {kind!r}: {UNPORTED_KINDS.get(kind, kind)}")
        self.kind = kind
        self.cfg = cfg
        self.ln1 = blocks.RMSNorm(cfg.d_model, cfg, device)
        self.attn = blocks.Attention(cfg, device)
        if cfg.d_ff > 0:
            self.ln2 = blocks.RMSNorm(cfg.d_model, cfg, device)
            self.ffn = blocks.MLP(cfg, device)

    def init(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init(gen)


def build_layers(cfg: ArchConfig, device=None) -> nn.ModuleList:
    """``init_stack``'s structure: one :class:`Layer` per layer, in order."""
    check_ported(cfg)
    unit, n_units, tail = cfg.scan_pattern()
    kinds = list(unit) * n_units + list(tail)
    return nn.ModuleList(Layer(kind, cfg, device) for kind in kinds)


def cache_shape(kind: str, cfg: ArchConfig, batch: int, s_max: int) -> tuple[int, ...]:
    """Shape of one layer's K (and V) cache; sliding-window layers get a
    RING cache of min(window, s_max) slots."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}: {UNPORTED_KINDS.get(kind, kind)}")
    size = s_max
    if kind == "attn_local" and cfg.sliding_window:
        size = min(s_max, cfg.sliding_window)
    return (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)


def init_stack_cache(
    layers: nn.ModuleList, batch: int, s_max: int, dtype, device=None
) -> dict[str, torch.Tensor]:
    """Zero-filled decode-time caches of every layer."""
    cache = {}
    for i, layer in enumerate(layers):
        shape = cache_shape(layer.kind, layer.cfg, batch, s_max)
        for part in ("k", "v"):
            cache[f"layers.{i}.{part}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def apply_layer(
    layer: Layer,
    x: torch.Tensor,
    *,
    mode: str,  # train | prefill | decode
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache: dict[str, torch.Tensor] | None = None,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Returns (x_out, cache_out): the written cache in prefill mode, the
    cache updated in place in decode mode, None in train mode.  ``rope`` is
    the (sin, cos) of positions 0..S-1 for train and prefill, of positions
    ``lengths`` for decode."""
    cfg = layer.cfg
    window = layer_window(layer.kind, cfg)
    new_cache = None
    h = layer.ln1(x, cfg.norm_eps)
    if mode == "decode":
        a = layer.attn.decode(h, cache, lengths, *rope, window=window)
        new_cache = cache
    else:
        a, k, v = layer.attn(h, *rope, causal=not cfg.encoder_only, window=window)
        if mode == "prefill":
            if layer.kind == "attn_local" and window:
                # ring cache: keep the last `window` positions at slot
                # abs_pos % window (RoPE already applied absolutely)
                s = k.shape[1]
                w = min(s, window)
                k = torch.roll(k[:, s - w :], (s - w) % w, dims=1)
                v = torch.roll(v[:, s - w :], (s - w) % w, dims=1)
            new_cache = {"k": k, "v": v}
    x = x + a
    if cfg.d_ff > 0:
        x = x + layer.ffn(layer.ln2(x, cfg.norm_eps))
    return x, new_cache


def apply_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    mode: str,
    cache: dict[str, torch.Tensor] | None = None,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Run every layer in order.  Returns (x, cache): prefill emits a new
    cache, decode returns ``cache`` written in place, train None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    # RoPE tables once for the whole stack (the reference builds them per layer)
    pos = lengths if mode == "decode" else torch.arange(x.shape[1], device=x.device)
    rope = blocks.rope_tables(pos, cfg.resolved_head_dim, cfg.rotary_fraction, cfg.rope_theta)
    out_cache = {} if mode != "train" else None
    for i, layer in enumerate(layers):
        lc = None
        if mode == "decode":
            lc = {"k": cache[f"layers.{i}.k"], "v": cache[f"layers.{i}.v"]}
        x, nc = apply_layer(layer, x, mode=mode, rope=rope, cache=lc, lengths=lengths)
        if nc is not None:
            out_cache[f"layers.{i}.k"], out_cache[f"layers.{i}.v"] = nc["k"], nc["v"]
    return x, out_cache
