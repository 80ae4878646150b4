"""zamba2-2.7b [arXiv:2411.15242] — hybrid: Mamba2 backbone with a shared
attention block applied periodically.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64; shared
attention every 6 mamba layers (9 applications). The published model uses two
alternating shared blocks with LoRA-specialisation; we use one shared block
(noted in DESIGN.md)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240, vocab=32000,
    ssm_state=64, attn_every=6,
)
