"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable) and
sLSTM (scalar memory with recurrent gate connections, sequential scan).
Port of ``repro/nn/xlstm.py``, plain torch as the reference is plain ``jnp``.

mLSTM parallel (prefill) uses the stabilised attention-like form:
    F_t = cumsum log sigmoid(f̃);  D̃_ts = F_t - F_s + ĩ_s  (s <= t)
    m_t = max_s D̃_ts;   W_ts = exp(D̃_ts - m_t) (q_t·k_s/√d)
    y_t = Σ_s W_ts v_s / max(|Σ_s W_ts|, exp(-m_t))
mLSTM decode carries per-head matrix memory C [P, P], normaliser n [P],
stabiliser m (scalar, -inf before the first step).

sLSTM is a strict recurrence (gates see R h_{t-1}): a loop over time for
both prefill and decode, with exponential-gate stabilisation.

Mixed dtypes: with bf16 weights the projections are bf16 while the
recurrent state stays f32. Elementwise products promote as JAX does; every
contraction casts its operands to f32 first, as the reference writes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Linear, linear
from repro_torch.nn.norms import RMSNorm, rmsnorm

f32 = torch.float32

# ---------------------------------------------------------------- mLSTM ----


class MLSTM(nn.Module):
    def __init__(self, dim: int, n_heads: int, *, expand: int = 2,
                 dtype=f32, device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        d_inner = expand * dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.up = Linear(dim, 2 * d_inner, **kw)                # -> (x, gate)
        self.wq = Linear(d_inner, d_inner, **kw)
        self.wk = Linear(d_inner, d_inner, **kw)
        self.wv = Linear(d_inner, d_inner, **kw)
        self.wi = Linear(d_inner, n_heads, bias=True, **kw)
        self.wf = Linear(d_inner, n_heads, bias=True, **kw)
        self.norm = RMSNorm(d_inner, dtype=dtype, device=device)
        self.down = Linear(d_inner, dim, **kw)


def _mlstm_qkvif(params: MLSTM, x, n_heads: int):
    B, S, _ = x.shape
    u = linear(params.up, x)
    xi, gate = torch.chunk(u, 2, dim=-1)
    d_inner = xi.shape[-1]
    P = d_inner // n_heads
    q = linear(params.wq, xi).reshape(B, S, n_heads, P)
    k = linear(params.wk, xi).reshape(B, S, n_heads, P) / (P ** 0.5)
    v = linear(params.wv, xi).reshape(B, S, n_heads, P)
    i_pre = linear(params.wi, xi).to(f32)                               # [B, S, H]
    f_pre = linear(params.wf, xi).to(f32)
    return q, k, v, i_pre, f_pre, gate, d_inner, P


def _causal(L: int, device):
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))[None, :, :, None]


def _mlstm_out(params: MLSTM, y, gate):
    y = rmsnorm(params.norm, y) * F.silu(gate)
    return linear(params.down, y)


def mlstm_parallel(params: MLSTM, x, *, n_heads: int, return_state: bool = False):
    """x [B, S, dim] -> y [B, S, dim] (quadratic parallel form).
    With return_state, also returns the recurrent (C, n, m) state after S
    steps (equivalent to running mlstm_decode S times)."""
    B, S, dim = x.shape
    q, k, v, i_pre, f_pre, gate, d_inner, P = _mlstm_qkvif(params, x, n_heads)
    logf = F.logsigmoid(f_pre)                                          # [B, S, H]
    Fc = torch.cumsum(logf, dim=1)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]   # [B,t,s,H]
    dmat = dmat.masked_fill(~_causal(S, x.device), float("-inf"))
    m = torch.amax(dmat, dim=2, keepdim=True)                           # [B,t,1,H]
    w = torch.exp(dmat - m)                                             # [B,t,s,H]
    qk = torch.einsum("bthp,bshp->btsh", q.to(f32), k.to(f32))
    cmat = w * qk
    num = torch.einsum("btsh,bshp->bthp", cmat, v.to(f32))
    denom = torch.maximum(torch.abs(torch.sum(cmat, dim=2)), torch.exp(-m[:, :, 0, :]))
    y = (num / denom[..., None]).reshape(B, S, d_inner).to(x.dtype)
    out = _mlstm_out(params, y, gate)
    if return_state:
        # state after step S: decay of entry s is F_S - F_s + i_s
        d_end = Fc[:, -1:, :] - Fc + i_pre                              # [B, S, H]
        m_T = torch.amax(d_end, dim=1)                                  # [B, H]
        w = torch.exp(d_end - m_T[:, None, :])                          # [B, S, H]
        kf, vf = k.to(f32), v.to(f32)
        C = torch.einsum("bsh,bshp,bshq->bhpq", w, kf, vf)
        n = torch.einsum("bsh,bshp->bhp", w, kf)
        return out, {"C": C, "n": n, "m": m_T}
    return out


def mlstm_chunkwise(params: MLSTM, x, *, n_heads: int, chunk: int = 256,
                    return_state: bool = False):
    """Chunkwise-parallel mLSTM: quadratic only within a chunk, a loop
    carries the (C, n, m) recurrent state across chunks. Matches
    mlstm_parallel (same stabilised math) while materialising
    O(S·chunk·H) instead of O(S²·H)."""
    B, S, dim = x.shape
    if S <= chunk:
        return mlstm_parallel(params, x, n_heads=n_heads, return_state=return_state)
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    q, k, v, i_pre, f_pre, gate, d_inner, P = _mlstm_qkvif(params, x, n_heads)
    nc, L, H = S // chunk, chunk, n_heads

    def rc(t):                                   # [B,S,...] -> [nc,B,L,...]
        return torch.movedim(t.reshape(B, nc, L, *t.shape[2:]), 1, 0)

    qc, kc, vc = rc(q.to(f32)), rc(k.to(f32)), rc(v.to(f32))
    ic, fc = rc(i_pre), rc(F.logsigmoid(f_pre))
    causal = _causal(L, x.device)
    C_p = torch.zeros((B, H, P, P), dtype=f32, device=x.device)
    n_p = torch.zeros((B, H, P), dtype=f32, device=x.device)
    m_p = torch.full((B, H), float("-inf"), dtype=f32, device=x.device)
    ys = []
    for q_k, k_k, v_k, i_k, lf_k in zip(qc, kc, vc, ic, fc):
        Fc = torch.cumsum(lf_k, dim=1)           # [B,L,H] local decay prefix
        # intra-chunk decay D[t,s] = F_t - F_s + i_s  (s <= t)
        dloc = Fc[:, :, None, :] - Fc[:, None, :, :] + i_k[:, None, :, :]
        dloc = dloc.masked_fill(~causal, float("-inf"))
        # carried-state decay at local t: m_p + F_t (-inf before any state)
        dst = m_p[:, None, :] + Fc               # [B,L,H]
        m_t = torch.maximum(torch.amax(dloc, dim=2), dst)       # [B,L,H]
        w_loc = torch.exp(dloc - m_t[:, :, None, :])            # [B,t,s,H]
        w_st = torch.exp(dst - m_t)                             # [B,L,H]
        qk = torch.einsum("bthp,bshp->btsh", q_k, k_k)
        cmat = w_loc * qk
        num = (torch.einsum("btsh,bshp->bthp", cmat, v_k)
               + w_st[..., None] * torch.einsum("bhpq,bthp->bthq", C_p, q_k))
        den = (torch.sum(cmat, dim=2)
               + w_st * torch.einsum("bhp,bthp->bth", n_p, q_k))
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        ys.append(num / den[..., None])                         # [B,L,H,P]
        # state at chunk end: decay of local entry s is F_L - F_s + i_s
        d_end = Fc[:, -1:, :] - Fc + i_k                        # [B,L,H]
        m_end = torch.maximum(m_p + Fc[:, -1], torch.amax(d_end, dim=1))  # [B,H]
        w_end = torch.exp(d_end - m_end[:, None, :])            # [B,L,H]
        f_carry = torch.exp(m_p + Fc[:, -1] - m_end)            # [B,H]
        C_p = (f_carry[..., None, None] * C_p
               + torch.einsum("bsh,bshp,bshq->bhpq", w_end, k_k, v_k))
        n_p = f_carry[..., None] * n_p + torch.einsum("bsh,bshp->bhp", w_end, k_k)
        m_p = m_end
    y = torch.stack(ys, dim=1).reshape(B, S, d_inner).to(x.dtype)
    out = _mlstm_out(params, y, gate)
    if return_state:
        return out, {"C": C_p, "n": n_p, "m": m_p}
    return out


def make_mlstm_state(batch: int, dim: int, n_heads: int, *, expand: int = 2,
                     device="cpu"):
    d_inner = expand * dim
    P = d_inner // n_heads
    return {"C": torch.zeros((batch, n_heads, P, P), dtype=f32, device=device),
            "n": torch.zeros((batch, n_heads, P), dtype=f32, device=device),
            "m": torch.full((batch, n_heads), float("-inf"), dtype=f32, device=device)}


def mlstm_decode(params: MLSTM, x, state, *, n_heads: int):
    """One-token recurrent step. x [B, 1, dim] -> (y, new state)."""
    B, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    q, k, v, i_pre, f_pre, gate, d_inner, P = _mlstm_qkvif(params, x, n_heads)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                                 # [B, H, P]
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                             # [B, H]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_sc = torch.exp(logf + state["m"] - m_new)
    i_sc = torch.exp(i_pre - m_new)
    C = state["C"] * f_sc[..., None, None] + i_sc[..., None, None] * (
        k[..., :, None] * v[..., None, :])                              # [B,H,P,P]
    n = state["n"] * f_sc[..., None] + i_sc[..., None] * k
    qf = q.to(f32)
    num = torch.einsum("bhpq,bhp->bhq", C, qf)
    den = torch.maximum(torch.abs(torch.sum(n * qf, dim=-1)), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, d_inner).to(x.dtype)
    return _mlstm_out(params, y, gate), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------- sLSTM ----


class GateBlock(nn.Module):
    """W x (dense, biased) plus the block-diagonal recurrence r [H, P, P]."""

    def __init__(self, dim: int, n_heads: int, *, dtype=f32, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        P = dim // n_heads
        self.w = Linear(dim, dim, bias=True, dtype=dtype, device=device, generator=generator)
        r = torch.randn((n_heads, P, P), generator=generator, device=device, dtype=f32)
        self.r = nn.Parameter((r * (1.0 / P ** 0.5)).to(dtype), requires_grad=False)


class SLSTM(nn.Module):
    GATES = ("z", "i", "f", "o")

    def __init__(self, dim: int, n_heads: int, *, ff_factor: float = 4 / 3,
                 dtype=f32, device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        hid = int(ff_factor * dim)
        for g in self.GATES:
            setattr(self, g, GateBlock(dim, n_heads, **kw))
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.ff_up = Linear(dim, hid, **kw)
        self.ff_dn = Linear(hid, dim, **kw)


def _slstm_gate(gp: GateBlock, wx_t, h_prev):
    """wx_t [B, dim] (precomputed W·x), h_prev [B, H, P] -> pre-act [B, dim]."""
    B = wx_t.shape[0]
    rec = torch.einsum("bhp,hpq->bhq", h_prev.to(f32), gp.r.to(f32)).reshape(B, -1)
    return wx_t.to(f32) + rec


def make_slstm_state(batch: int, dim: int, n_heads: int, *, device="cpu"):
    P = dim // n_heads
    sh = (batch, n_heads, P)
    return {"c": torch.zeros(sh, dtype=f32, device=device),
            "n": torch.full(sh, 1e-6, dtype=f32, device=device),
            "h": torch.zeros(sh, dtype=f32, device=device),
            "m": torch.zeros(sh, dtype=f32, device=device)}


def _slstm_step(params: SLSTM, state, wx_t, n_heads: int):
    """wx_t: dict gate -> [B, dim] precomputed input projections."""
    B, dim = wx_t["z"].shape
    P = dim // n_heads
    h_prev = state["h"]

    def pre(g):
        return _slstm_gate(getattr(params, g), wx_t[g], h_prev).reshape(B, n_heads, P)

    zt = torch.tanh(pre("z"))
    it = pre("i")
    ft = pre("f")
    ot = torch.sigmoid(pre("o"))
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(logf + state["m"] - m_new)
    c = f_sc * state["c"] + i_sc * zt
    n = torch.clamp(f_sc * state["n"] + i_sc, min=1e-6)
    h = ot * (c / n)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(params: SLSTM, h):
    h = rmsnorm(params.norm, h)
    return linear(params.ff_dn, F.gelu(linear(params.ff_up, h), approximate="tanh"))


def slstm_scan(params: SLSTM, x, *, n_heads: int, return_state: bool = False):
    """x [B, S, dim] -> y [B, S, dim], sequential over S; the four input
    projections run batched over every position before the loop. (The
    reference's two-level scan and remat only shape its backward pass.)"""
    B, S, dim = x.shape
    wx = {g: linear(getattr(params, g).w, x) for g in SLSTM.GATES}     # [B, S, dim]
    state = make_slstm_state(B, dim, n_heads, device=x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(params, state, {g: w[:, t] for g, w in wx.items()}, n_heads)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, dim).to(x.dtype)
    out = _slstm_out(params, h)
    if return_state:
        return out, state
    return out


def slstm_decode(params: SLSTM, x, state, *, n_heads: int):
    """One-token step. x [B, 1, dim] -> (y, new state)."""
    B, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    wx_t = {g: linear(getattr(params, g).w, x[:, 0]) for g in SLSTM.GATES}
    new = _slstm_step(params, state, wx_t, n_heads)
    h = new["h"].reshape(B, 1, dim).to(x.dtype)
    return _slstm_out(params, h), new
