"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40 experts
top-8 (assignment header; the bracketed HF card is a smaller sibling — we
follow the explicit spec)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
)
