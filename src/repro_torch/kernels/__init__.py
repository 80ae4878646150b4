"""Hand-written Hopper CUDA kernels for the serving data plane:
flash_attention (prefill), decode_attention (GQA decode against a KV
cache) and moe_combine (a MoE layer's gated combine). ops.py routes by
tensor device, ref.py holds the plain versions, build.py compiles
csrc/*.cu with nvcc at first use."""
from repro_torch.kernels import ops, ref
