"""grok-1-314b [moe]: 64L d6144 48H GQA(kv=8) ff32768 v131072.

8 experts top-2.  [hf:xai-org/grok-1; unverified]
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, group_size=1024),
    scan_unit=1,
    grad_accum=8,
    opt_factored=True,
    opt_moment_dtype="bfloat16",
    accum_dtype="bfloat16",

    param_dtype="bfloat16",
    remat="full",
)
