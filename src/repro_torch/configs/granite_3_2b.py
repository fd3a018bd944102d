"""granite-3-2b [dense]: 40L d2048 32H GQA(kv=8) ff8192 v49155.

[hf:ibm-granite/granite-3.0-2b-base; hf].  Vocab 49155 pads to 49408 for
even sharding (ArchConfig.padded_vocab).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    rope_theta=10000.0,
    grad_accum=2,
    scan_unit=1,
    remat="full",
)
