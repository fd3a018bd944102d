"""mistral-nemo-12b [dense]: 40L d5120 32H GQA(kv=8) ff14336 v131072.

128k context; explicit head_dim=128 (not d_model/n_heads=160).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000.0,
    grad_accum=2,
    scan_unit=1,
    remat="full",
)
