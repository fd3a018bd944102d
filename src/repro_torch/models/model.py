"""Model = token embedding + layer stack + final norm + LM head: the
serving path's part of ``repro.models.model``.

``Model`` is an ``nn.Module`` holding its parameters (``embed``, ``layers``,
``final_ln``) in ``cfg.param_dtype`` with the JAX package's layouts.
:meth:`Model.init` draws them from an explicit ``torch.Generator``; the
JAX package's own weights come across through ``repro_torch.interop``.
Ported: the LM families whose layers are all ``attn``/``attn_local`` with
dense FFNs.  The ``audio`` and ``vlm`` frontends, ``loss`` and
``chunked_softmax_xent`` come with the training slice (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks, transformer
from repro_torch.models.config import ArchConfig


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} frontend is not ported yet (ROADMAP.md §1 item 7)"
            )
        transformer.check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = blocks.Embedding(cfg, dev)
        self.layers = transformer.build_layers(cfg, dev)
        self.final_ln = blocks.RMSNorm(cfg.d_model, cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.final_ln.scale.device

    # -- init ----------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device):
        normals scaled as ``Model.init`` scales them, norm scales zero."""
        self.embed.init(generator)
        for layer in self.layers:
            layer.init(generator)
        self.final_ln.init(generator)
        return self

    # -- forward passes --------------------------------------------------------

    @torch.no_grad()
    def hidden(
        self,
        batch: dict,
        *,
        mode: str,
        cache: dict[str, torch.Tensor] | None = None,
        lengths: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
        cfg = self.cfg
        x = self.embed.embed(batch["tokens"].to(self.device))
        x, cache_out = transformer.apply_stack(
            self.layers, x, cfg, mode=mode, cache=cache, lengths=lengths
        )
        return self.final_ln(x, cfg.norm_eps), cache_out

    @torch.no_grad()
    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Process the full prompt; returns (last-position logits [B, V],
        cache)."""
        x, cache = self.hidden(batch, mode="prefill")
        return self.embed.logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(
        self,
        batch: dict,  # {"tokens": [B, 1]}
        cache: dict[str, torch.Tensor],
        lengths: torch.Tensor,  # [B]
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One token for every sequence; returns (logits [B, V], cache).  The
        cache is written in place (see ``blocks.Attention.decode``)."""
        x, cache = self.hidden(batch, mode="decode", cache=cache, lengths=lengths)
        return self.embed.logits(x[:, 0]), cache

    def init_cache(self, batch: int, s_max: int) -> dict[str, torch.Tensor]:
        return transformer.init_stack_cache(
            self.layers, batch, s_max, blocks.cdtype(self.cfg), self.device
        )

    def cache_shapes(self, batch: int, s_max: int) -> dict[str, tuple[int, ...]]:
        """Shape of every cache leaf for ``(batch, s_max)`` without
        allocating: ``Model.abstract_cache``."""
        out = {}
        for i, layer in enumerate(self.layers):
            shape = transformer.cache_shape(layer.kind, self.cfg, batch, s_max)
            out[f"layers.{i}.k"] = out[f"layers.{i}.v"] = shape
        return out
