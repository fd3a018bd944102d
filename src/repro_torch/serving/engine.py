"""Batched serving engine: prefill -> padded KV cache -> greedy decode
(``repro.serving.engine``).

Static shapes as in the reference: the cache is padded to ``s_max``,
per-sequence validity is a ``lengths`` vector, and every decode step runs
the same shapes.  The cache is a dict of tensors (``Model.init_cache``'s
keys), written in place by each decode step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model


def pad_cache_to(
    cache: dict[str, torch.Tensor], target: dict[str, tuple[int, ...]] | int
) -> dict[str, torch.Tensor]:
    """Pad every KV leaf's sequence axis (third from last) to its target.

    ``target`` is either the cache's shapes for the serving ``s_max``
    (``Model.cache_shapes``: ring-buffer leaves keep their window size) or
    a plain int applied to all KV leaves (keys ending in ``.k``/``.v``)."""
    out = {}
    for key, leaf in cache.items():
        if key.rsplit(".", 1)[-1] not in ("k", "v"):
            out[key] = leaf
            continue
        want = target if isinstance(target, int) else target[key][-3]
        s = leaf.shape[-3]
        if s < want:
            leaf = torch.nn.functional.pad(leaf, (0, 0, 0, 0, 0, want - s))
        out[key] = leaf
    return out


@dataclasses.dataclass
class ServeEngine:
    """``model`` holds its parameters (``repro.serving.engine.ServeEngine``
    takes them as ``params``)."""

    model: Model
    s_max: int

    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor], torch.Tensor]:
        """Returns (next_tokens [B], padded cache, lengths [B] int32)."""
        b, s = batch["tokens"].shape[:2]
        if s > self.s_max:
            raise ValueError(f"prompt of {s} tokens exceeds s_max={self.s_max}")
        logits, cache = self.model.prefill(batch)
        cache = pad_cache_to(cache, self.model.cache_shapes(b, self.s_max))
        lengths = torch.full((b,), s, dtype=torch.int32, device=logits.device)
        return torch.argmax(logits, dim=-1), cache, lengths

    def decode(
        self,
        first_tokens: torch.Tensor,  # [B]
        cache: dict[str, torch.Tensor],
        lengths: torch.Tensor,
        n_steps: int,
    ) -> torch.Tensor:
        """Greedy-decode ``n_steps`` tokens; returns [B, n_steps].  The
        reference clamps a write past the cache's end onto its last slot;
        the port refuses a run that would reach past ``s_max``."""
        if n_steps and int(lengths.max()) + n_steps > self.s_max:
            raise ValueError(
                f"decoding {n_steps} tokens after {int(lengths.max())} exceeds s_max={self.s_max}"
            )
        toks = first_tokens
        out = []
        for _ in range(n_steps):
            logits, cache = self.model.decode_step({"tokens": toks[:, None]}, cache, lengths)
            lengths = lengths + 1
            toks = torch.argmax(logits, dim=-1)
            out.append(toks)
        if not out:
            return first_tokens.new_zeros((first_tokens.shape[0], 0))
        return torch.stack(out, dim=1)

    def generate(self, batch: dict, n_steps: int) -> torch.Tensor:
        """prefill + greedy decode in one call: [B, n_steps] tokens."""
        first, cache, lengths = self.prefill(batch)
        rest = self.decode(first, cache, lengths, n_steps - 1)
        return torch.cat([first[:, None], rest], dim=1)
