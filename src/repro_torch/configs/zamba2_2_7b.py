"""zamba2-2.7b [hybrid]: 54L d2560 32H(kv=32) ff10240 v32000 ssm_state=64.

Mamba2 backbone with ONE shared-weight attention+MLP block applied every
6th position (9 applications of the same parameters).  Scan unit = 6
(shared-attn+mamba, then 5 mamba).  [arXiv:2411.15242; hf]
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    shared_attn_every=6,
    grad_accum=4,
    scan_unit=6,
    remat="full",
)
