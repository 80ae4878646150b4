"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B language backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000. Vision tower (anyres CLIP tiling) is a STUB — input_specs()
provides projected patch embeddings (n_patches=576 base tile)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    n_patches=576,
)
