"""Neural-net layers of the port. Each layer is an ``nn.Module`` that holds
the parameters under the reference's pytree names, plus a function of the
reference's name that applies it:
    Linear / linear, Embedding / embedding, RMSNorm / rmsnorm, ...
The serving layers create their parameters without gradients; the OPD
networks built from them (policy, predictor) switch gradients on.
"""
from repro_torch.nn.linear import Linear, linear, linear_rows, linear_cols, Embedding, embedding
from repro_torch.nn.norms import RMSNorm, rmsnorm, LayerNorm, layernorm
from repro_torch.nn.rope import rope_frequencies, apply_rope
from repro_torch.nn.mlp import MLP, mlp
from repro_torch.nn.attention import (
    Attention, attention_prefill, attention_decode, make_kv_cache,
    init_cross_attention, cross_attention,
)
from repro_torch.nn.moe import MoE, moe
from repro_torch.nn.mamba2 import Mamba2, mamba2_scan, mamba2_decode, make_mamba_state
from repro_torch.nn.xlstm import (
    MLSTM, mlstm_parallel, mlstm_chunkwise, mlstm_decode, make_mlstm_state,
    SLSTM, slstm_scan, slstm_decode, make_slstm_state,
)
from repro_torch.nn.lstm import LSTM, lstm_scan
from repro_torch.nn.resnet import ResBlock, resblock, ResMLP, res_mlp
