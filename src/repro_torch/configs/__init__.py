"""Architecture registry: one module per assigned architecture.

The same data and functions as ``repro.configs``, kept as the port's own
copy.  ``get_config(arch)`` returns the full published config; ``smoke_config``
returns the reduced same-family config used by CPU smoke tests (full
configs are exercised only via the abstract dry-run).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig, XLSTMConfig

ARCHS = (
    "chatglm3_6b",
    "granite_3_2b",
    "mistral_nemo_12b",
    "gemma3_27b",
    "hubert_xlarge",
    "mixtral_8x22b",
    "grok_1_314b",
    "zamba2_2_7b",
    "llama_3_2_vision_11b",
    "xlstm_1_3b",
)

#: canonical ids (as in the assignment) -> module names
ALIASES = {
    "chatglm3-6b": "chatglm3_6b",
    "granite-3-2b": "granite_3_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma3-27b": "gemma3_27b",
    "hubert-xlarge": "hubert_xlarge",
    "mixtral-8x22b": "mixtral_8x22b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config: small widths/layers/experts, tiny vocab."""
    cfg = get_config(arch)
    unit, _, _ = cfg.scan_pattern()
    # two scan units so every layer kind and the scan path are exercised
    small_layers = len(unit) * 2 if unit else 2
    replace: dict = dict(
        n_layers=small_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        head_dim=32 if cfg.head_dim else None,
        frontend_dim=32 if cfg.frontend_dim else None,
        n_image_tokens=16 if cfg.family == "vlm" else cfg.n_image_tokens,
        d_vision=48 if cfg.family == "vlm" else cfg.d_vision,
        sliding_window=64 if cfg.sliding_window else None,
        grad_accum=1,
        remat="none",
    )
    if cfg.moe:
        replace["moe"] = MoEConfig(
            n_experts=4, top_k=2, capacity_factor=cfg.moe.capacity_factor,
            group_size=64,
        )
    if cfg.ssm:
        replace["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32
        )
    if cfg.xlstm:
        replace["xlstm"] = XLSTMConfig(
            slstm_every=cfg.xlstm.slstm_every, mlstm_chunk=32,
            conv_window=cfg.xlstm.conv_window,
        )
    return dataclasses.replace(cfg, **replace)


def all_arch_ids() -> list[str]:
    return list(ALIASES)
