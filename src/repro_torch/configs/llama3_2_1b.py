"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, rope theta 5e5."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv=8, d_ff=8192, vocab=128256,
    rope_theta=500000.0,
)
