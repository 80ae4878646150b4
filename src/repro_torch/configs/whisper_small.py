"""whisper-small [arXiv:2212.04356] — encoder-decoder; conv/mel frontend is a
STUB (input_specs() provides encoder frame embeddings, enc_len=1500).

Decoder backbone: 12L d_model=768 12H (MHA, kv=12) d_ff=3072 vocab=51865,
learned positions, GELU MLP, LayerNorm."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    enc_len=1500, mlp_kind="gelu", norm="layernorm", rope_theta=None,
)
