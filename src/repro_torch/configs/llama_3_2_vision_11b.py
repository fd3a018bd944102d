"""llama-3.2-vision-11b [vlm]: 40L d4096 32H GQA(kv=8) ff14336 v128256.

Gated cross-attention image layers every 5th layer; the vision tower is a
STUB (input_specs supply patch embeddings [B, n_img, d_vision]).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1024,
    d_vision=1280,
    grad_accum=4,
    scan_unit=5,
    remat="full",
)
