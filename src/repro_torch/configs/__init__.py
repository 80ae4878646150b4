"""Ported architecture registry: the dense-family configs of the first
slice. Each module defines CONFIG, the exact published configuration, and
cites its source in the docstring. The other families' configs arrive with
their model code."""
from repro_torch.configs import llama3_2_1b, starcoder2_3b

ARCHS = {m.CONFIG.name: m.CONFIG for m in (starcoder2_3b, llama3_2_1b)}


def get_arch(name: str):
    return ARCHS[name]
