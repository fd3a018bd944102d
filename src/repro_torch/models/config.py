"""Architecture configuration for the model zoo.

A copy of ``repro.models.config`` (plain dataclasses, nothing to port), so
the port imports nothing of the JAX package.  One ``ArchConfig`` per
assigned architecture lives in ``repro_torch/configs/``.  The config fully
determines parameter shapes, the layer pattern (scan units), and which
serving shapes are applicable (encoder-only archs have no decode step; pure
full-attention archs skip long_500k — DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    #: tokens per dispatch group (s_g); capacity rounds up to 128-multiples
    group_size: int = 4096

    def capacity(self, group_size: int | None = None) -> int:
        """Slots per expert per group, rounded up to the 8-sublane multiple."""
        g = group_size or self.group_size
        c = int(g * self.top_k / self.n_experts * self.capacity_factor)
        return max(8, -(-c // 8) * 8)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2/SSD block parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM stack: mLSTM blocks with an sLSTM block every ``slstm_every``."""

    slstm_every: int = 8  # xLSTM[7:1]
    mlstm_chunk: int = 128
    conv_window: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    #: fraction of head_dim that rotates (chatglm3 "2d RoPE" = 0.5)
    rotary_fraction: float = 1.0
    #: sliding-window size for local-attention layers (None = full)
    sliding_window: int | None = None
    #: gemma3 pattern: this many local layers per global layer (0 = all full)
    local_per_global: int = 0
    logit_softcap: float | None = None
    #: cross-attention (image) layer every Nth layer (llama-3.2-vision)
    cross_attn_every: int | None = None
    n_image_tokens: int = 1024
    d_vision: int = 1280
    #: encoder-only (hubert): bidirectional attention, no decode step
    encoder_only: bool = False
    frontend_dim: int | None = None  # audio/vision stub frame-embedding width

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    #: zamba2: shared-weight attention block every Nth position
    shared_attn_every: int | None = None

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"

    #: layers per scan unit (pattern length); n_layers % scan_unit may leave
    #: a tail that is executed unscanned
    scan_unit: int = 1
    #: gradient-accumulation microbatches in train_step
    grad_accum: int = 1
    remat: Literal["none", "full", "dots"] = "full"
    #: optimizer memory knobs (Adafactor-style factored nu; bf16 momentum)
    opt_factored: bool = False
    opt_moment_dtype: str = "float32"
    #: gradient-accumulation dtype (grok: bf16 to fit 16 GB/chip)
    accum_dtype: str = "float32"
    #: chunk the optimizer update of big stacked leaves (transient bound)
    opt_update_chunks: int = 1

    def __post_init__(self):
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embedding/head shard any mesh axis."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.xlstm is not None

    # -- shape-cell applicability (DESIGN.md §4) -----------------------------

    def supports_decode(self) -> bool:
        return not self.encoder_only

    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic archs."""
        if self.encoder_only:
            return False
        if self.family in ("ssm", "hybrid"):
            return True
        # gemma3: 5:1 local:global — dominated by 1024-window layers
        return self.local_per_global >= 5

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, length n_layers.  Kinds:
        attn (full), attn_local (windowed), attn_cross (image cross-attn),
        mamba, mamba_shared_attn, mlstm, slstm."""
        kinds: list[str] = []
        for i in range(self.n_layers):
            if self.family == "hybrid" and self.ssm is not None:
                if (
                    self.shared_attn_every
                    and i % self.shared_attn_every == 0
                ):
                    kinds.append("mamba_shared_attn")
                else:
                    kinds.append("mamba")
            elif self.xlstm is not None:
                if (i + 1) % self.xlstm.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.cross_attn_every and i % self.cross_attn_every == (
                self.cross_attn_every - 1
            ):
                kinds.append("attn_cross")
            elif self.local_per_global:
                # gemma3: L,L,L,L,L,G repeating
                kinds.append(
                    "attn"
                    if (i + 1) % (self.local_per_global + 1) == 0
                    else "attn_local"
                )
            elif self.sliding_window is not None:
                kinds.append("attn_local")
            else:
                kinds.append("attn")
        return kinds

    def scan_pattern(self) -> tuple[list[str], int, list[str]]:
        """(unit_kinds, n_units, tail_kinds): the stack is ``unit_kinds``
        scanned ``n_units`` times followed by unscanned ``tail_kinds``."""
        kinds = self.layer_kinds()
        u = self.scan_unit
        n_units = self.n_layers // u
        unit = kinds[:u]
        # verify the pattern actually repeats; otherwise fall back to tail
        for r in range(n_units):
            if kinds[r * u : (r + 1) * u] != unit:
                n_units = r
                break
        tail = kinds[n_units * u :]
        return unit, n_units, tail
