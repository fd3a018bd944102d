"""Transformer building blocks: norms, RoPE, GQA attention, gated MLP,
embedding and LM head — the serving path's part of ``repro.models.blocks``.

Conventions, as in the JAX package:
 * parameters are stored in ``cfg.param_dtype`` (float32) with the JAX
   package's layouts: ``wq`` [d, Hq, hd], ``wk``/``wv`` [d, Hkv, hd],
   ``wo`` [Hq, hd, d], ``w1``/``w3`` [d, ff], ``w2`` [ff, d], ``table``
   [V, d], ``head`` [d, V];
 * activations flow in the compute dtype ``cfg.dtype`` (bf16), statistics
   and softmax in float32.

The reference casts every float32 weight to bf16 at each use
(``p["wq"].astype(dt)``).  The port casts once and keeps the cast beside
the parameter (:meth:`Weights.cast`), recast only when a parameter changes
(its version counter moves) or moves; the cast gives the same bits, so
the result is the same.

RMSNorm, prefill attention and decode attention go through
``repro_torch.kernels.ops``: the hand-written CUDA kernels on the card,
their plain versions on the CPU.  Where the JAX model computes these three
in plain jnp (``apply_rmsnorm``, ``blocked_attention``, the single-shot
cache attention of ``decode_attention_step``), the port calls the kernels
that compute the same functions.  ``shard(...)`` annotations are
identities on one device and are left out.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _normal(shape, gen: torch.Generator, scale: float, dtype, device) -> torch.Tensor:
    """``(normal(shape) * scale).astype(dtype)``, drawn from ``gen``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


class Weights(nn.Module):
    """A module whose parameters are used in the compute dtype: the cast is
    made once and kept until a parameter changes."""

    names: tuple[str, ...] = ()

    def _param(self, name: str, shape, cfg: ArchConfig, device) -> None:
        setattr(self, name, nn.Parameter(torch.zeros(shape, dtype=pdtype(cfg), device=device)))

    def cast(self, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        params = [getattr(self, n) for n in self.names]
        key = (dtype, tuple((p._version, p.data_ptr(), p.dtype) for p in params))
        if self.__dict__.get("_cast_key") != key:
            with torch.no_grad():
                self.__dict__["_cast"] = tuple(p.detach().to(dtype) for p in params)
            self.__dict__["_cast_key"] = key
        return self.__dict__["_cast"]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, cfg: ArchConfig, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=pdtype(cfg), device=device))

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        self.scale.zero_()

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return ops.rmsnorm(x, self.scale, eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full / partial-"2d" fraction)
# ---------------------------------------------------------------------------


def rope_tables(
    positions: torch.Tensor, head_dim: int, fraction: float, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape [..., rot_dim/2] for the rotating slice."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exps)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``2*half`` slice of head_dim; pass the rest through
    (chatglm3's partial/"2d" RoPE uses fraction 0.5)."""
    half = sin.shape[-1]
    rot, rest = x[..., : 2 * half], x[..., 2 * half :]
    x1f, x2f = rot[..., ::2].to(torch.float32), rot[..., 1::2].to(torch.float32)
    sin = sin.to(torch.float32)
    cos = cos.to(torch.float32)
    r1 = x1f * cos - x2f * sin
    r2 = x2f * cos + x1f * sin
    out = torch.stack([r1, r2], dim=-1).reshape(rot.shape).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class Attention(Weights):
    names = ("wq", "wk", "wv", "wo")

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        self.cfg = cfg
        self._param("wq", (d, hq, hd), cfg, device)
        self._param("wk", (d, hkv, hd), cfg, device)
        self._param("wv", (d, hkv, hd), cfg, device)
        self._param("wo", (hq, hd, d), cfg, device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        s = 1.0 / math.sqrt(cfg.d_model)
        for name, scale in (
            ("wq", s), ("wk", s), ("wv", s), ("wo", s / math.sqrt(cfg.n_layers)),
        ):
            p = getattr(self, name)
            p.copy_(_normal(p.shape, gen, scale, p.dtype, p.device))

    def _qkv(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
        """q [B, S, Hq, hd], k, v [B, S, Hkv, hd] in the compute dtype, RoPE
        applied to q and k at the positions of (sin, cos) [S or B, half]."""
        wq, wk, wv, _ = self.cast(x.dtype)
        b, s, d = x.shape
        x2 = x.reshape(b * s, d)
        q = (x2 @ wq.reshape(d, -1)).reshape(b, s, *wq.shape[1:])
        k = (x2 @ wk.reshape(d, -1)).reshape(b, s, *wk.shape[1:])
        v = (x2 @ wv.reshape(d, -1)).reshape(b, s, *wv.shape[1:])
        sin, cos = sin[..., None, :], cos[..., None, :]  # broadcast over heads
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        """[B, S, Hq, hd] -> [B, S, d] through wo."""
        wo = self.cast(o.dtype)[3]
        b, s = o.shape[:2]
        return (o.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])).reshape(b, s, -1)

    def forward(
        self,
        x: torch.Tensor,  # [B, S, d]
        sin: torch.Tensor,  # [S, half]
        cos: torch.Tensor,
        *,
        causal: bool = True,
        window: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence attention (train / prefill): ``blocks.apply_attention``.
        Returns (y [B, S, d], k [B, S, Hkv, hd] after RoPE, v): the K/V the
        prefill cache keeps.  The reference computes them a second time for
        the cache; they are the same values, so the port computes them once."""
        q, k, v = self._qkv(x, sin, cos)
        o = ops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=self.cfg.logit_softcap
        )
        return self._out(o), k, v

    def decode(
        self,
        x: torch.Tensor,  # [B, 1, d]
        cache: dict[str, torch.Tensor],  # {"k": [B, S_cache, Hkv, hd], "v": ...}
        lengths: torch.Tensor,  # [B] tokens so far (absolute position of x)
        sin: torch.Tensor,  # [B, half] at positions ``lengths``
        cos: torch.Tensor,
        *,
        window: int | None = None,
    ) -> torch.Tensor:
        """One-token cached attention: ``blocks.decode_attention_step``.

        Writes the new K/V into ``cache`` **in place** at slot
        ``lengths % S_cache`` (a ring cache of a sliding-window layer) or
        ``lengths``, then attends over the first ``lengths + 1`` slots.  The
        reference returns a new cache; writing in place saves a copy of every
        layer's cache per token.  Returns y [B, 1, d]."""
        k_cache, v_cache = cache["k"], cache["v"]
        s_cache = k_cache.shape[1]
        ring = window is not None and s_cache <= window
        q, k_new, v_new = self._qkv(x, sin[:, None], cos[:, None])  # [B, 1, H, hd]
        slots = (lengths % s_cache if ring else lengths).long()
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache[rows, slots] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, slots] = v_new[:, 0].to(v_cache.dtype)
        if ring:
            window = None  # ring residency already enforces the window
        o = ops.decode_attention(
            q[:, 0], k_cache, v_cache, lengths + 1, softcap=self.cfg.logit_softcap, window=window
        )
        return self._out(o[:, None].to(x.dtype))


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

#: the activations of the ported configs (gelu belongs to the audio family)
_ACTS = {"silu": torch.nn.functional.silu}


class MLP(Weights):
    names = ("w1", "w3", "w2")

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self._param("w1", (d, ff), cfg, device)
        self._param("w3", (d, ff), cfg, device)
        self._param("w2", (ff, d), cfg, device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        d, ff = self.w1.shape
        s_in = 1.0 / math.sqrt(d)
        s_out = 1.0 / math.sqrt(ff) / math.sqrt(cfg.n_layers)
        for name, scale in (("w1", s_in), ("w3", s_in), ("w2", s_out)):
            p = getattr(self, name)
            p.copy_(_normal(p.shape, gen, scale, p.dtype, p.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, w3, w2 = self.cast(x.dtype)
        h = _ACTS[self.cfg.act](x @ w1) * (x @ w3)
        return h @ w2


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


class Embedding(Weights):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        v = cfg.padded_vocab  # padded so the vocab axis shards evenly
        self._param("table", (v, cfg.d_model), cfg, device)
        self.names = ("table",)
        if not cfg.tie_embeddings:
            self._param("head", (cfg.d_model, v), cfg, device)
            self.names = ("table", "head")

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        for name in self.names:
            p = getattr(self, name)
            p.copy_(_normal(p.shape, gen, 0.02, p.dtype, p.device))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """``blocks.embed_tokens``: rows of the table times sqrt(d_model).
        The factor is rounded to the compute dtype first, as JAX rounds a
        weak-typed Python scalar before a bf16 multiply; torch would
        multiply a bf16 tensor by a Python float in float32."""
        dt = cdtype(self.cfg)
        table = self.cast(dt)[0]
        factor = torch.tensor(math.sqrt(self.cfg.d_model), dtype=dt, device=table.device)
        return table[tokens] * factor

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``blocks.logits``: [..., d] -> [..., padded vocab] in x's dtype."""
        w = self.cast(x.dtype)
        return x @ (w[0].T if self.cfg.tie_embeddings else w[1])
