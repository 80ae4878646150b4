"""starcoder2-3b [arXiv:2402.19173] — GQA kv=2, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. StarCoder2 uses a
GELU MLP and layernorm."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288, vocab=49152,
    mlp_kind="gelu", norm="layernorm",
)
