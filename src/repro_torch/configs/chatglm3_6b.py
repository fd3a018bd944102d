"""chatglm3-6b [dense]: 28L d4096 32H GQA(kv=2) ff13696 v65024.

RoPE "2d" = partial rotary on half the head dim (rotary_fraction=0.5),
the GLM-family convention.  [arXiv:2406.12793; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rotary_fraction=0.5,
    rope_theta=10000.0,
    grad_accum=2,
    scan_unit=1,
    remat="full",
)
