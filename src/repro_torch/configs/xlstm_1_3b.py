"""xlstm-1.3b [ssm]: 48L d2048 4H v50304, d_ff=0 (no FFN blocks).

sLSTM + mLSTM stack at ratio 7:1 (one sLSTM every 8 blocks); attention-free,
O(1)-state decode (the long_500k cell).  [arXiv:2405.04517; unverified]
"""

from repro_torch.models.config import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_chunk=128, conv_window=4),
    grad_accum=4,
    scan_unit=8,
    remat="full",
)
