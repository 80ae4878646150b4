"""Mamba2 (SSD) block: chunked state-space scan for the forward and prefill,
and a single-step recurrence for decode. Port of ``repro/nn/mamba2.py``.

Per head h, state H_t in R^{P x N}:
    H_t = exp(dt_t * a_h) * H_{t-1} + dt_t * x_t B_t^T
    y_t[p] = sum_n H_t[p, n] C_t[n]
with x projected to heads of dim P, B/C of dim N shared across heads, a
scalar decay per head, softplus dt per token and head, a causal depthwise
conv over (x, B, C), a gated output (z branch) and RMSNorm before the
out-projection. ``a_log``, ``dt_bias``, ``d_skip`` and the SSM state stay
float32, as in the reference.

The scan is chunked: within a chunk the contribution is a dense quadratic
form, across chunks a Python loop carries the [B, H, P, N] state (the
reference's ``lax.scan``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Linear, _normal, linear
from repro_torch.nn.norms import RMSNorm, rmsnorm

CONV_K = 4  # depthwise conv kernel width


class Mamba2(nn.Module):
    """Four separate input projections (``in_z``, ``in_x``, ``in_bc``,
    ``in_dt``), the conv (``conv_w`` [K, conv_dim], ``conv_b``), ``a_log``
    (A = -exp(a_log)), ``dt_bias``, ``d_skip``, ``norm`` and ``out_proj``,
    under the reference's names."""

    def __init__(self, dim: int, *, expand: int = 2, n_heads: int, d_state: int,
                 dtype=torch.float32, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        d_inner = expand * dim
        if d_inner % n_heads:
            raise ValueError(f"d_inner {d_inner} is not divisible by {n_heads} heads")
        conv_dim = d_inner + 2 * d_state
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_z = Linear(dim, d_inner, **kw)
        self.in_x = Linear(dim, d_inner, **kw)
        self.in_bc = Linear(dim, 2 * d_state, **kw)
        self.in_dt = Linear(dim, n_heads, **kw)
        self.conv_w = _normal((CONV_K, conv_dim), std=CONV_K ** -0.5, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype, device=device),
                                   requires_grad=False)
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
                                  requires_grad=False)
        self.dt_bias = nn.Parameter(torch.zeros(n_heads, **f32), requires_grad=False)
        self.d_skip = nn.Parameter(torch.ones(n_heads, **f32), requires_grad=False)
        self.norm = RMSNorm(d_inner, dtype=dtype, device=device)
        self.out_proj = Linear(d_inner, dim, **kw)


def _split_proj(params: Mamba2, x, d_state: int):
    z = linear(params.in_z, x)
    xs = linear(params.in_x, x)
    B, C = torch.split(linear(params.in_bc, x), d_state, dim=-1)
    dt = linear(params.in_dt, x)
    return z, xs, B, C, dt


def _causal_conv(params: Mamba2, u, state=None):
    """u [B, S, conv_dim] -> same shape; depthwise causal conv of width
    CONV_K. ``state`` [B, CONV_K-1, conv_dim] holds the trailing context
    for decode. Returns (out, new_state)."""
    w = params.conv_w.to(torch.float32)
    if state is None:
        pad = torch.zeros((u.shape[0], CONV_K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1).to(torch.float32)                 # [B, S+K-1, D]
    S = u.shape[1]
    out = sum(full[:, i:i + S] * w[i] for i in range(CONV_K))
    out = F.silu(out + params.conv_b.to(torch.float32))
    new_state = full[:, -(CONV_K - 1):].to(u.dtype)
    return out.to(u.dtype), new_state


def _chunk_step(H_prev, xh_k, B_k, C_k, ld_k, dt_k):
    """One chunk of the SSD scan: xh_k [B, L, H, P], B_k/C_k [B, L, N],
    ld_k/dt_k [B, L, H], H_prev [B, H, P, N] -> (H_new, y [B, L, H, P])."""
    L = xh_k.shape[1]
    cum = torch.cumsum(ld_k, dim=1)                                      # [B, L, H]
    # intra-chunk: y[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t.B_s) x_s
    decay_ts = cum[:, :, None, :] - cum[:, None, :, :]                   # [B, t, s, H]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cum.device))
    # mask the exponent, not the exp: for s > t it is large and positive
    g = torch.exp(decay_ts.masked_fill(~causal[None, :, :, None], -torch.inf))
    cb = torch.einsum("btn,bsn->bts", C_k, B_k)
    w = g * cb[..., None] * dt_k[:, None, :, :]                          # [B, t, s, H]
    y_intra = torch.einsum("btsh,bshp->bthp", w, xh_k)
    # carried state: y_state[t] = exp(cum_t) C_t . H_prev
    y_state = torch.einsum("bthn,bhpn->bthp",
                           torch.exp(cum)[:, :, :, None] * C_k[:, :, None, :], H_prev)
    # H = exp(cum_L) H_prev + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
    tail = torch.exp(cum[:, -1:, :] - cum)                               # [B, L, H]
    H_new = (torch.exp(cum[:, -1])[:, :, None, None] * H_prev
             + torch.einsum("blh,blhp,bln->bhpn", tail * dt_k, xh_k, B_k))
    return H_new, y_intra + y_state


def mamba2_scan(params: Mamba2, x, *, n_heads: int, d_state: int, expand: int = 2,
                chunk: int = 256, return_state: bool = False):
    """Full-sequence SSD. x [B, S, dim] -> y [B, S, dim] (or (y, state),
    the state usable by ``mamba2_decode``, with ``return_state``). The
    sequence must be a multiple of ``min(chunk, S)``; it is not padded."""
    Bsz, S, dim = x.shape
    d_inner = expand * dim
    P = d_inner // n_heads
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by chunk {chunk}")
    z, xs, Bmat, Cmat, dt = _split_proj(params, x, d_state)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, _ = _causal_conv(params, conv_in)
    xs, Bmat, Cmat = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params.dt_bias)               # [B, S, H]
    a = -torch.exp(params.a_log)                                         # [H]
    log_decay = dt * a                                                   # [B, S, H]

    xh = xs.reshape(Bsz, S, n_heads, P).to(torch.float32)
    Bm = Bmat.to(torch.float32)
    Cm = Cmat.to(torch.float32)
    H = torch.zeros((Bsz, n_heads, P, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        H, y_k = _chunk_step(H, xh[:, sl], Bm[:, sl], Cm[:, sl], log_decay[:, sl],
                             dt[:, sl])
        ys.append(y_k)
    y = torch.cat(ys, dim=1)                                             # [B, S, H, P]
    y = y + params.d_skip[None, None, :, None] * xh
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rmsnorm(params.norm, y) * F.silu(z)
    out = linear(params.out_proj, y)
    if return_state:
        return out, {"ssm": H, "conv": conv_in[:, -(CONV_K - 1):]}    # pre-conv inputs
    return out


def make_mamba_state(batch: int, dim: int, *, n_heads: int, d_state: int,
                     expand: int = 2, dtype=torch.float32, device="cpu"):
    d_inner = expand * dim
    P = d_inner // n_heads
    return {
        "ssm": torch.zeros((batch, n_heads, P, d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * d_state), dtype=dtype,
                            device=device),
    }


def mamba2_decode(params: Mamba2, x, state, *, n_heads: int, d_state: int,
                  expand: int = 2):
    """One-token step. x [B, 1, dim] -> (y [B, 1, dim], new_state). The
    state it was given is left untouched."""
    Bsz, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    d_inner = expand * dim
    P = d_inner // n_heads
    z, xs, Bmat, Cmat, dt = _split_proj(params, x, d_state)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, conv_state = _causal_conv(params, conv_in, state["conv"])
    xs, Bmat, Cmat = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt[:, 0].to(torch.float32) + params.dt_bias)        # [B, H]
    a = -torch.exp(params.a_log)
    decay = torch.exp(dt * a)                                            # [B, H]
    xh = xs[:, 0].reshape(Bsz, n_heads, P).to(torch.float32)
    Bm = Bmat[:, 0].to(torch.float32)                                    # [B, N]
    Cm = Cmat[:, 0].to(torch.float32)

    H = state["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bm)
    y = torch.einsum("bhpn,bn->bhp", H, Cm) + params.d_skip[None, :, None] * xh
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = rmsnorm(params.norm, y) * F.silu(z)
    return linear(params.out_proj, y), {"ssm": H, "conv": conv_state}
