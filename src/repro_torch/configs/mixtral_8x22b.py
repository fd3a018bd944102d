"""mixtral-8x22b [moe]: 56L d6144 48H GQA(kv=8) ff16384 v32768.

8 experts top-2, sliding-window attention (4096).  [arXiv:2401.04088; hf]
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    rope_theta=1000000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, group_size=1024),
    scan_unit=1,
    grad_accum=8,
    opt_factored=True,
    remat="full",
)
