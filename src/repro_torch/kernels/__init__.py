"""Hand-written Hopper CUDA kernels for the serving data plane:
flash_attention (prefill) and decode_attention (GQA decode against a KV
cache). ops.py routes by tensor device, ref.py holds the plain versions,
build.py compiles csrc/*.cu with nvcc at first use."""
from repro_torch.kernels import ops, ref
