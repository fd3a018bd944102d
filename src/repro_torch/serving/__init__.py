"""Batched serving: prefill, a padded KV cache, greedy decode."""

from repro_torch.serving.engine import ServeEngine, pad_cache_to

__all__ = ["ServeEngine", "pad_cache_to"]
