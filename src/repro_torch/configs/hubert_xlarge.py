"""hubert-xlarge [audio]: 48L d1280 16H ff5120, 504 cluster targets.

Encoder-only (bidirectional attention, no decode path).  The conv waveform
frontend is a STUB: input_specs supply precomputed frame embeddings
[B, S, frontend_dim] (DESIGN.md §4).  [arXiv:2106.07447; unverified]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    frontend_dim=512,
    act="gelu",
    grad_accum=2,
    scan_unit=1,
    remat="full",
)
