"""xlstm-125m [arXiv:2405.04517] — sLSTM + mLSTM blocks.

12L d_model=768 4H (kv=4) d_ff=0 (block-internal up-projections)
vocab=50304; every 4th layer is sLSTM (xLSTM[7:1]-style ratio)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    slstm_every=4, rope_theta=None,
)
