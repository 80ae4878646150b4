"""Architecture configuration and the input-shape suite.

Field-for-field copy of ``repro/models/config.py``; ``param_dtype`` maps the
dtype name to a torch dtype instead of ``jnp.dtype``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 0          # llama4: MoE every k-th layer (others dense)
    # ssm / hybrid
    ssm_state: int = 0
    attn_every: int = 0         # zamba2: shared attention block every k mamba layers
    # xlstm
    slstm_every: int = 0        # every k-th layer is sLSTM (others mLSTM)
    # modality frontends (stubs — embeddings provided by input_specs)
    enc_len: int = 0            # whisper: encoder frames
    n_patches: int = 0          # vlm: vision patch embeddings
    # flavour
    mlp_kind: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float | None = 10000.0
    window: int | None = None   # sliding-window attention (long-context decode variant)
    dtype: str = "float32"
    remat: bool = True
    use_flash: bool = False     # CPU only: route attention through the kernels' plain versions

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r} "
                             f"(one of {sorted(_DTYPES)})")
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> ArchConfig:
        return dataclasses.replace(self, **kw)

    def smoke(self) -> ArchConfig:
        """Reduced variant of the same family for CPU smoke tests."""
        d = min(self.d_model, 256)
        heads = 4
        kv = min(self.n_kv, heads)
        kw = dict(
            n_layers=2, d_model=d, n_heads=heads, n_kv=kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512), dtype="float32", remat=False,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.enc_len:
            kw.update(enc_len=16)
        if self.n_patches:
            kw.update(n_patches=8)
        if self.window:
            kw.update(window=16)
        return self.replace(**kw)

    def param_count(self) -> float:
        """Approximate parameter count (used for 6ND model-flops)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) + (self.n_heads * hd) * d
        if self.family == "ssm":         # xlstm: mixture of mLSTM/sLSTM blocks
            per_layer = 2 * d * 4 * d + 4 * d * d // 2   # rough
        elif self.family == "hybrid":
            d_in = 2 * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state + 32) + d_in * d
        else:
            per_layer = attn
        mlp_total = 0.0
        if self.n_experts:
            n_moe = L // self.moe_every if self.moe_every > 1 else L
            mlp_total += n_moe * (self.n_experts * 3 * d * self.d_ff
                                  + d * self.n_experts)
            if self.moe_every > 1 and self.d_ff:     # interleaved dense layers
                mlp_total += (L - n_moe) * 3 * d * self.d_ff
        elif self.d_ff:
            mult = 3 if self.mlp_kind == "swiglu" else 2
            mlp_total += L * mult * d * self.d_ff
        emb = self.vocab * d * 2
        if self.family == "audio":       # cross-attention adds ~one attn per layer
            per_layer += attn
        return L * per_layer + mlp_total + emb

    def active_param_count(self) -> float:
        """Active params per token (MoE counts only top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        n_moe = (self.n_layers // self.moe_every if self.moe_every > 1
                 else self.n_layers)
        expert_all = n_moe * self.n_experts * 3 * self.d_model * self.d_ff
        dense = self.param_count() - expert_all
        return dense + n_moe * self.top_k * 3 * self.d_model * self.d_ff


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long-context decode uses a ring-buffer window cache for attention archs
LONG_WINDOW = 8_192
