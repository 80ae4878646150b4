"""Mamba2 (SSD) block: chunked state-space scan for the forward and prefill,
and a single-step recurrence for decode. Port of ``repro/nn/mamba2.py``.

Per head h, state H_t in R^{P x N}:
    H_t = exp(dt_t * a_h) * H_{t-1} + dt_t * x_t B_t^T
    y_t[p] = sum_n H_t[p, n] C_t[n]
with x projected to heads of dim P, B/C of dim N shared across heads, a
scalar decay per head, softplus dt per token and head, a causal depthwise
conv over (x, B, C), a gated output (z branch) and RMSNorm before the
out-projection. ``a_log``, ``dt_bias``, ``d_skip`` and the SSM state stay
float32, as in the reference; the scan computes in float32 (float64 for a
float64 input).

The scan is chunked: within a chunk the contribution is a dense quadratic
form, across chunks a Python loop carries the [B, H, P, N] state (the
reference's ``lax.scan``).

Under a running mesh (``distributed.collectives``) a rank may hold column
blocks of ``in_z``/``in_x`` (its channels of ``d_inner``: whole heads, or
a block inside one head where the ranks outnumber the heads) and the
matching row block of ``out_proj``, as the rules place them;
``in_bc``, ``in_dt``, the conv, ``a_log``, ``dt_bias``, ``d_skip`` and
``norm`` stay whole and the rank applies its channels' and heads' slice
(``norms.rank_slice``, through ``copy``). Every channel's recurrence is
its own, so the rank scans its heads alone; the gated norm sums its
squares over "model" (``norms.rmsnorm_block``) and ``out_proj`` sums the
partial products. The SSM state is the rank's heads (the cache rule splits
it on H); where the heads do not divide the model axis it is whole, and
decode sums the rank's block of the new state into it. The conv tail is whole by the rule, so decode gathers the new
token's x channels before it runs the conv and writes the tail. The
scan's collectives carry their transposes (one ``copy`` on every path
from a whole tensor to a rank's own use); decode is inference only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as col
from repro_torch.kernels.ref import acc_dtype
from repro_torch.nn.linear import Linear, _normal, linear, linear_rows, linear_shared
from repro_torch.nn.norms import RMSNorm, rank_slice, rmsnorm_block

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


def _local(params: Mamba2, n_heads: int) -> tuple[int, int, int, int, int]:
    """(d_inner, this rank's channels Cl of it, the first head h0 they lie
    in, the number of heads Hl they touch, the channels Pl of each): all of
    them off a mesh, or where ``in_x`` is held whole. A rank's channels are
    whole heads, or a block inside one head (more ranks than heads)."""
    d_inner = params.norm.g.shape[0]
    Cl = params.in_x.w.shape[1]
    P = d_inner // n_heads
    if Cl == d_inner:
        return d_inner, Cl, 0, n_heads, P
    h0 = col.index("model") * Cl // P
    if Cl % P == 0:
        return d_inner, Cl, h0, Cl // P, P
    if P % Cl == 0:
        return d_inner, Cl, h0, 1, Cl
    raise ValueError(f"a rank's {Cl} of {d_inner} channels are neither whole heads of "
                     f"{P} nor a block inside one")


def _split_proj(params: Mamba2, x, d_state: int):
    """z, x (the rank's channels), B, C, dt (every head). A rank holding
    blocks of ``in_z``/``in_x`` takes ``x`` through ``copy`` and the whole
    ``in_bc``/``in_dt`` through ``linear_shared``: it uses them for its own
    channels."""
    split = params.in_x.w.shape[1] < params.norm.g.shape[0]
    if split:
        x = col.copy(x, "model")
    lin = linear_shared if split else linear
    z = linear(params.in_z, x)
    xs = linear(params.in_x, x)
    B, C = torch.split(lin(params.in_bc, x), d_state, dim=-1)
    dt = lin(params.in_dt, x)
    return z, xs, B, C, dt


def _conv_slice(params: Mamba2, d_inner: int, Cl: int):
    """The conv weight [K, Cl + 2N] and bias of this rank's x channels and
    every B, C channel."""
    if Cl == d_inner:
        return params.conv_w, params.conv_b
    lo = col.index("model") * Cl
    w, b = col.copy(params.conv_w, "model"), col.copy(params.conv_b, "model")
    return (torch.cat([w[:, lo:lo + Cl], w[:, d_inner:]], dim=1),
            torch.cat([b[lo:lo + Cl], b[d_inner:]]))


def _causal_conv(params: Mamba2, u, state=None, w=None, b=None):
    """u [B, S, conv_dim] -> same shape; depthwise causal conv of width
    CONV_K with ``w``/``b`` (default the whole ``conv_w``/``conv_b``).
    ``state`` [B, CONV_K-1, conv_dim] holds the trailing context for
    decode. Returns (out, new_state)."""
    acc = acc_dtype(u)
    w = (params.conv_w if w is None else w).to(acc)
    b = params.conv_b if b is None else b
    if state is None:
        pad = torch.zeros((u.shape[0], CONV_K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1).to(acc)                           # [B, S+K-1, D]
    S = u.shape[1]
    out = sum(full[:, i:i + S] * w[i] for i in range(CONV_K))
    out = F.silu(out + b.to(acc))
    new_state = full[:, -(CONV_K - 1):].to(u.dtype)
    return out.to(u.dtype), new_state


def _heads(params: Mamba2, dt, h0: int, Hl: int):
    """(softplus dt, A, d_skip) of the Hl heads from h0 this rank's channels
    lie in, from ``dt`` [..., H] of every head (computed by
    ``linear_shared``, so it is sliced as is)."""
    H = dt.shape[-1]
    if Hl == H:
        dt_bias, a_log, d_skip = params.dt_bias, params.a_log, params.d_skip
    else:
        dt = dt.narrow(-1, h0, Hl)
        dt_bias, a_log, d_skip = (col.copy(p, "model").narrow(0, h0, Hl)
                                  for p in (params.dt_bias, params.a_log, params.d_skip))
    dt = F.softplus(dt.to(acc_dtype(dt)) + dt_bias)
    return dt, -torch.exp(a_log), d_skip


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
    the state usable by ``mamba2_decode``, with ``return_state``; off a
    mesh, or with whole weights). The sequence must be a multiple of
    ``min(chunk, S)``; it is not padded."""
    Bsz, S, dim = x.shape
    d_inner, Cl, h0, Hl, Pl = _local(params, n_heads)
    if return_state and Cl < d_inner:
        raise ValueError("return_state takes the whole weights; on a mesh decode "
                         "carries the state (mamba2_decode)")
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by chunk {chunk}")
    z, xs, Bmat, Cmat, dt = _split_proj(params, x, d_state)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, _ = _causal_conv(params, conv_in, None, *_conv_slice(params, d_inner, Cl))
    xs, Bmat, Cmat = torch.split(conv_out, [Cl, d_state, d_state], dim=-1)

    dt, a, d_skip = _heads(params, dt, h0, Hl)                           # [B, S, Hl]
    log_decay = dt * a                                                   # [B, S, Hl]

    acc = acc_dtype(x)
    xh = xs.reshape(Bsz, S, Hl, Pl).to(acc)
    Bm = Bmat.to(acc)
    Cm = Cmat.to(acc)
    H = torch.zeros((Bsz, Hl, Pl, d_state), dtype=acc, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        H, y_k = _chunk_step(H, xh[:, sl], Bm[:, sl], Cm[:, sl], log_decay[:, sl],
                             dt[:, sl])
        ys.append(y_k)
    y = torch.cat(ys, dim=1)                                             # [B, S, Hl, Pl]
    y = y + d_skip[None, None, :, None] * xh
    y = y.reshape(Bsz, S, Cl).to(x.dtype)
    y = rmsnorm_block(params.norm, y, d_inner) * F.silu(z)
    out = linear_rows(params.out_proj, y, d_inner)
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
    state it was given is left untouched. On a mesh ``state["ssm"]`` holds
    the rank's heads (or all of them, where the heads do not divide the
    model axis: the rank's block of the new state is then summed into the
    whole one) and ``state["conv"]`` the whole tail (module docstring)."""
    Bsz, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    d_inner, Cl, h0, Hl, Pl = _local(params, n_heads)
    z, xs, Bmat, Cmat, dt = _split_proj(params, x, d_state)
    if Cl < d_inner:                          # the tail is whole: gather the x channels
        xs = col.gather(xs, "model", -1)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, conv_state = _causal_conv(params, conv_in, state["conv"])
    xs, Bmat, Cmat = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    xs = rank_slice(xs, -1, Cl)

    dt, a, d_skip = _heads(params, dt[:, 0], h0, Hl)                     # [B, Hl]
    decay = torch.exp(dt * a)                                            # [B, Hl]
    acc = acc_dtype(x)
    xh = xs[:, 0].reshape(Bsz, Hl, Pl).to(acc)
    Bm = Bmat[:, 0].to(acc)                                              # [B, N]
    Cm = Cmat[:, 0].to(acc)

    ssm = state["ssm"]
    whole = ssm.shape[1] != Hl                # every head held, a block of one computed
    p0 = (col.index("model") * Cl) % (d_inner // n_heads)
    prev = ssm[:, h0:h0 + Hl, p0:p0 + Pl] if whole else ssm
    H = prev * decay[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bm)
    y = torch.einsum("bhpn,bn->bhp", H, Cm) + d_skip[None, :, None] * xh
    y = y.reshape(Bsz, 1, Cl).to(x.dtype)
    y = rmsnorm_block(params.norm, y, d_inner) * F.silu(z)
    if whole:
        full = torch.zeros_like(ssm)
        full[:, h0:h0 + Hl, p0:p0 + Pl] = H
        H = col.psum(full, "model")
    return linear_rows(params.out_proj, y, d_inner), {"ssm": H, "conv": conv_state}
