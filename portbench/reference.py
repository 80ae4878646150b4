"""The plain reference: the forward of each architecture the cells run, in
float32 with plain ``torch`` operations, layer by layer from the weights that
``weights`` makes again from the run's seed.

Each architecture's forward is in its reference module,
``portbench/archs/<module>.py`` (``spec.reference_module``: ``decoder`` for the
dense, moe and vlm families, ``whisper`` for audio, or the one its
configuration names); ``logits`` calls it. The parts they share are here:
RMSNorm (eps 1e-6) and LayerNorm (eps 1e-5), half-split RoPE, grouped-query
attention, the SwiGLU and tanh-GELU MLPs, and a top-k MoE whose router is
float32, its top-k gates renormalised, each expert taking at most
C = int(1.25 * S * k / E) tokens of a row, the highest gates first, ties to the
earlier token; and a Mamba2 mixer (``_mamba2``) under the port's
parameter names, its state-space recurrence run position by position with no
chunks. The stub frontends' inputs are made as the port's
``StageServer`` makes them: f32 normal, std 0.02, from a generator seeded 0
(patches) or 1 (frames), at the batch's own size, then rounded to the
weights' dtype.

Nothing here imports the program or JAX; it reads nothing the program made.
``quant="fp8"`` is the control, the reference computed one precision below
the configuration's bf16: every matrix rounded to float8 e4m3 with one scale a
tensor (an expert each), and every product's input rows rounded to e4m3 with
one scale a row, as an fp8 GEMM takes them; products accumulate in f32.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench import spec, weights as W


def _fp8(x: torch.Tensor, dims=None) -> torch.Tensor:
    if dims is None:
        dims = tuple(range(1, x.dim())) if x.dim() == 3 else tuple(range(x.dim()))
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w; in the control (``p["fp8"]``) with the rows of x in fp8."""
    return (_fp8(x, (-1,)) if p["fp8"] else x) @ w


def _weights(arch, seed, stage, variant, index, device, quant, params):
    """One group's weights in f32, keyed by name, and ``fp8``: the control's;
    ``params`` is the architecture's layout."""
    out = {"fp8": quant == "fp8"}
    for name, w in W.group(arch, seed, stage, variant, index, device, params).items():
        w = w.to(torch.float32)
        out[name] = _fp8(w) if out["fp8"] and w.dim() >= 2 else w
    return out


def _rmsnorm(x, g):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * g


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _norm(p, prefix, x):
    if f"{prefix}.b" in p:
        return _layernorm(x, p[f"{prefix}.g"], p[f"{prefix}.b"])
    return _rmsnorm(x, p[f"{prefix}.g"])


def _lin(p, prefix, x):
    y = _mm(x, p[f"{prefix}.w"], p)
    return y + p[f"{prefix}.b"] if f"{prefix}.b" in p else y


def _rope(x, theta):
    """x [B, S, H, D]: half-split rotation at positions 0..S-1."""
    S, D = x.shape[1], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, causal):
    """q [B, S, H, D], k/v [B, T, Hkv, D] -> [B, S, H*D]."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
    if causal:
        keep = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", s.softmax(-1), v).reshape(B, S, H * D)


def _self_attention(p, prefix, x, arch):
    B, S, _ = x.shape
    hd = arch["d_model"] // arch["n_heads"]
    q = _lin(p, f"{prefix}.wq", x).view(B, S, -1, hd)
    k = _lin(p, f"{prefix}.wk", x).view(B, S, -1, hd)
    v = _lin(p, f"{prefix}.wv", x).view(B, S, -1, hd)
    if arch.get("rope_theta") is not None and arch["family"] != "audio":
        q, k = _rope(q, arch["rope_theta"]), _rope(k, arch["rope_theta"])
    return _lin(p, f"{prefix}.wo", _attend(q, k, v, True))


def _mlp(p, prefix, x, kind):
    if kind == "swiglu":
        h = F.silu(_lin(p, f"{prefix}.wg", x)) * _lin(p, f"{prefix}.wu", x)
        return _mm(h, p[f"{prefix}.wd.w"], p)
    return _lin(p, f"{prefix}.w2", F.gelu(_lin(p, f"{prefix}.w1", x), approximate="tanh"))


def _moe(p, prefix, x, arch):
    """Top-k routing, each expert keeping its C highest-gated tokens of a row."""
    B, S, d = x.shape
    E, k = arch["n_experts"], arch["top_k"]
    probs = _mm(x, p[f"{prefix}.router.w"], p).softmax(-1)                # [B, S, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter_(-1, top_e, top_p)
    C = max(1, min(S, int(1.25 * S * k / E)))
    order = torch.sort(gates.transpose(1, 2), dim=-1, descending=True, stable=True).indices
    keep = torch.zeros(B, E, S, dtype=torch.bool, device=x.device)
    keep.scatter_(-1, order[..., :C], True)
    keep = keep.transpose(1, 2) & (gates > 0)                              # [B, S, E]
    wg, wu, wd = (p[f"{prefix}.experts.{n}"] for n in ("wg", "wu", "wd"))
    y = torch.zeros_like(x)
    for e in range(E):
        b, s = keep[..., e].nonzero(as_tuple=True)
        if b.numel():
            xe = x[b, s]
            h = F.silu(_mm(xe, wg[e], p)) * _mm(xe, wu[e], p)
            y.index_put_((b, s), _mm(h, wd[e], p) * gates[b, s, e][:, None], accumulate=True)
    return y


MAMBA_CONV = 4  # a Mamba2 mixer's causal depthwise conv width


def _gated_norm(p, prefix, y, z, groups: int, eps: float, gate_first: bool):
    """The RMSNorm of ``y`` gated by SiLU(z), over each group's channels:
    ``gate_first`` normalises y * SiLU(z) (published Mamba2,
    ``norm_before_gate=False``), else normalises y and then multiplies by
    SiLU(z) (the port's form)."""
    if gate_first:
        y = y * F.silu(z)
    v = y.unflatten(-1, (groups, -1))
    v = (v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps)).flatten(-2)
    v = v * p[f"{prefix}.norm.g"]
    return v if gate_first else v * F.silu(z)


def _ssd(x, dt, a, b, c, d_skip):
    """The state-space recurrence, one position after another: x [B, S, H,
    P], dt [B, S, H] (after softplus), a [H] (negative), b and c [B, S, H, N]
    (each head's group's), d_skip [H] -> y [B, S, H, P]; per head
    H_t = exp(dt_t a) H_{t-1} + dt_t x_t b_t^T and y_t = H_t c_t + D x_t."""
    Bsz, S, H, P = x.shape
    state = torch.zeros(Bsz, H, P, b.shape[-1], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * a)[..., None, None]
        state = decay * state + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1) + d_skip[:, None] * x


def _mamba2(p, prefix, x, *, heads: int, d_state: int, eps: float, groups: int = 1,
            gate_first: bool = True):
    """A Mamba2 mixer, x [B, S, d] -> [B, S, d]: the projections ``in_z``,
    ``in_x``, ``in_bc`` (B then C, ``groups`` x ``d_state`` each) and ``in_dt``;
    a causal depthwise conv of width 4 over [x, B, C] (``conv_w`` [4, C],
    whose last row multiplies the current position; ``conv_b``) and SiLU;
    dt = softplus(dt + ``dt_bias``), A = -exp(``a_log``); the recurrence
    (``_ssd``; heads share B and C within a group) with the skip ``d_skip``;
    the gated RMSNorm (``_gated_norm``, per group) and ``out_proj``."""
    Bsz, S, _ = x.shape
    z = _lin(p, f"{prefix}.in_z", x)
    u = torch.cat([_lin(p, f"{prefix}.in_x", x), _lin(p, f"{prefix}.in_bc", x)], dim=-1)
    dt = _lin(p, f"{prefix}.in_dt", x)
    w = p[f"{prefix}.conv_w"]
    u = F.pad(u, (0, 0, MAMBA_CONV - 1, 0))
    u = F.silu(sum(u[:, i:i + S] * w[i] for i in range(MAMBA_CONV)) + p[f"{prefix}.conv_b"])
    xs, bm, cm = torch.split(u, [z.shape[-1], groups * d_state, groups * d_state], dim=-1)
    dt = F.softplus(dt + p[f"{prefix}.dt_bias"])
    a = -torch.exp(p[f"{prefix}.a_log"])
    bm, cm = (m.view(Bsz, S, groups, d_state).repeat_interleave(heads // groups, dim=2)
              for m in (bm, cm))
    y = _ssd(xs.view(Bsz, S, heads, -1), dt, a, bm, cm, p[f"{prefix}.d_skip"])
    y = _gated_norm(p, prefix, y.reshape(Bsz, S, -1), z, groups, eps, gate_first)
    return _lin(p, f"{prefix}.out_proj", y)


def stub_inputs(batch: int, rows, shape, seed: int, device, dtype):
    """The stub frontend's input rows ``rows`` of a batch of ``batch``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    full = torch.randn((batch, *shape), generator=gen, device=device, dtype=torch.float32)
    return (full[list(rows)] * 0.02).to(dtype).to(torch.float32)


def stub_rows(batch_rows, shape, seed: int, device, dtype):
    """The stub frontend's inputs of the rows ``batch_rows`` [(batch size,
    row)], each made at its own batch's size."""
    return torch.cat([stub_inputs(b, [r], shape, seed, device, dtype) for b, r in batch_rows])


def logits(arch: dict, seed: int, stage: int, variant: int, tokens: np.ndarray,
           batch_rows: list[tuple[int, int]], device, quant: str | None = None,
           config: dict | None = None, root: Path = spec.ROOT):
    """Reference logits [k, S_total, vocab] (f32) of ``tokens`` [k, S], the
    inputs the stage received; ``batch_rows`` gives each row's (batch size,
    row) in the batch that carried it, for the stub frontends' inputs."""
    mod = spec.reference_for(arch, config, root)
    return mod.logits(arch, seed, stage, variant, tokens, batch_rows, device, quant)


def gaps(ref: torch.Tensor, served: np.ndarray) -> torch.Tensor:
    """[k, S_total]: by how much each served token's reference logit lies
    below the reference's best at its position (inf for a token outside the
    vocabulary); ``served`` [k, S_total]."""
    idx = torch.as_tensor(np.asarray(served, dtype=np.int64), device=ref.device)
    if idx.shape != ref.shape[:-1] or idx.min() < 0 or idx.max() >= ref.shape[-1]:
        return torch.full(ref.shape[:-1], float("inf"), device=ref.device)
    return ref.max(-1).values - ref.gather(-1, idx[..., None])[..., 0]


def gap_stats(ref: torch.Tensor, served: np.ndarray) -> dict:
    """The widest and the mean gap (the numbers compared) and, for setting
    limits, the share of positions off the reference's best, the gaps' 90th,
    95th and 99th percentiles and their mean up to the 95th."""
    g = gaps(ref, served).flatten().to(torch.float64)
    out = {"widest": float(g.max()), "off_best": float((g > 0).double().mean()),
           "mean": float(g.mean()), "served": int(g.numel())}
    if not torch.isfinite(g).all():
        return {**out, "p90": math.inf, "p95": math.inf, "p99": math.inf, "trim95": math.inf}
    q = torch.quantile(g, torch.tensor([0.9, 0.95, 0.99], dtype=g.dtype, device=g.device))
    return {**out, "p90": float(q[0]), "p95": float(q[1]), "p99": float(q[2]),
            "trim95": float(g[g <= q[1]].mean())}
