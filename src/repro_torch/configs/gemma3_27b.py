"""gemma3-27b [dense]: 62L d5376 32H GQA(kv=16) ff21504 v262144.

5:1 local(1024-token sliding window):global layer pattern, 128k context.
Scan unit = 6 (5 local + 1 global); 62 = 6*10 + 2 tail local layers.
[hf:google/gemma-3-27b-pt family; unverified]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    rope_theta=1000000.0,
    sliding_window=1024,
    local_per_global=5,
    scan_unit=6,
    grad_accum=8,
    remat="full",
)
