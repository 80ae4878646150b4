"""Feature extraction module (paper §IV-C): node+pipeline state -> FC
dimensionality reduction -> residual blocks -> unified feature vector."""
from __future__ import annotations

import torch

from repro_torch.nn.resnet import ResMLP, res_mlp

FEATURE_DIM = 128
N_BLOCKS = 3


def init_features(state_dim: int, *, dim: int = FEATURE_DIM,
                  n_blocks: int = N_BLOCKS, device="cpu",
                  generator: torch.Generator | None = None) -> ResMLP:
    return ResMLP(state_dim, dim, n_blocks, device=device, generator=generator)


def extract(params: ResMLP, state):
    """state [B, state_dim] -> features [B, FEATURE_DIM]."""
    return res_mlp(params, state)
