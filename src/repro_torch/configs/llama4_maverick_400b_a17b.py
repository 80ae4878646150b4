"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192/expert vocab=202048, MoE 128
experts top-1, early-fusion multimodal (text path exercised; fusion embeds
via input_specs stub are not required for the language backbone)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    n_experts=128, top_k=1,
    # HF card: interleave_moe_layer_step=2 — MoE every other layer (the
    # alternating dense layers give the "400b" total; all-MoE would be 773B)
    moe_every=2,
)
