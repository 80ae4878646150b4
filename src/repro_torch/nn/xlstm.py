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
contraction casts its operands to f32 first, as the reference writes it (to
float64 in the forwards for a float64 input: a precision check's
reference run).

Under a running mesh (``distributed.collectives``) a rank holds the blocks
the rules give it over "model": the mLSTM's ``up`` [d, 2·d_inner] split by
columns of its concatenation [xi | gate] (so on two ranks one holds xi and
the other the gate), ``wq``/``wk``/``wv`` by columns (this rank's channels
of ``d_inner``, which may be whole heads or a block inside one head) and
``down`` by rows; the sLSTM's ``ff_up``/``ff_dn``; everything else whole.
The mLSTM forward gathers ``up``'s output, and each rank computes the
output channels it holds: its heads' q·k weights (a head's q and k
gathered where the rank holds a block inside it) applied to its block of
v, the gated norm summing its squares over "model" and ``down`` its
partial products. mLSTM decode gathers q, k and v (a few KB), updates the
rank's block of the memory along its key dim (``C`` [B, H, P/M, P], ``n``
[B, H, P/M], as the cache rule splits them) and sums the partial
numerator and denominator over "model" in one all-reduce. The sLSTM's
recurrence needs the whole previous h, and its gates are whole, so every
rank runs it whole: the forward takes no collective before its
feed-forward, and decode gathers the state blocks once a step and keeps
its block of the new state. The forwards' collectives carry their
transposes; decode is inference only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as col
from repro_torch.kernels.ref import acc_dtype
from repro_torch.nn.linear import Linear, linear, linear_rows, linear_shared
from repro_torch.nn.norms import RMSNorm, rmsnorm, rmsnorm_block

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


def _mlstm_local(params: MLSTM, n_heads: int) -> tuple[int, int, int, int, int]:
    """(d_inner, head width P, this rank's channels Cl of d_inner, the first
    head h0 they lie in, the number Hn of heads they touch): all of them
    off a mesh. A rank's channels are whole heads or a block inside one."""
    d_inner = params.wq.w.shape[0]
    P = d_inner // n_heads
    Cl = params.wq.w.shape[1]
    if Cl == d_inner:
        return d_inner, P, Cl, 0, n_heads
    h0 = col.index("model") * Cl // P
    if Cl % P == 0:
        return d_inner, P, Cl, h0, Cl // P
    if P % Cl == 0:
        return d_inner, P, Cl, h0, 1
    raise ValueError(f"a rank's {Cl} of {d_inner} channels are neither whole heads of "
                     f"{P} nor a block inside one")


def _mlstm_up(params: MLSTM, x, d_inner: int):
    """(xi, gate) whole: ``up``'s output, gathered where the rank holds a
    column block of [xi | gate]."""
    if params.up.w.shape[1] < 2 * d_inner:
        u = col.gather(linear(params.up, col.copy(x, "model")), "model", -1)
    else:
        u = linear(params.up, x)
    return torch.chunk(u, 2, dim=-1)


def _mlstm_qkvif(params: MLSTM, x, n_heads: int):
    """q, k [B, S, Hn, P] of the heads this rank's channels lie in, v
    [B, S, Hn, Cl / Hn] (its channels), the gates' pre-activations
    [B, S, Hn], the gate [B, S, Cl] of its channels, Cl and P."""
    B, S, _ = x.shape
    d_inner, P, Cl, h0, Hn = _mlstm_local(params, n_heads)
    split = Cl < d_inner
    xi, gate = _mlstm_up(params, x, d_inner)
    if split:            # xi and the gate feed this rank's own channels and heads
        xi = col.copy(xi, "model")
        gate = col.copy(gate, "model").narrow(-1, col.index("model") * Cl, Cl)
    lin = linear_shared if split else linear
    q, k = linear(params.wq, xi), linear(params.wk, xi)
    v = linear(params.wv, xi).reshape(B, S, Hn, Cl // Hn)
    if Cl < P:           # a block inside one head: gather the head's q and k
        qk = col.copy(col.gather(torch.stack([q, k], dim=2), "model", -1), "model")
        q, k = qk.narrow(-1, h0 * P, P).unbind(2)
    q = q.reshape(B, S, Hn, P)
    k = k.reshape(B, S, Hn, P) / (P ** 0.5)
    acc = acc_dtype(x)
    i_pre = lin(params.wi, xi).to(acc).narrow(-1, h0, Hn)               # [B, S, Hn]
    f_pre = lin(params.wf, xi).to(acc).narrow(-1, h0, Hn)
    return q, k, v, i_pre, f_pre, gate, Cl, P


def _causal(L: int, device):
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))[None, :, :, None]


def _mlstm_out(params: MLSTM, y, gate):
    """``down`` of the gated norm of ``y``: this rank's channels (with the
    gate's), or all of them, which ``linear_rows`` cuts to its rows."""
    d_inner = params.norm.g.shape[0]
    y = rmsnorm_block(params.norm, y, d_inner) * F.silu(gate)
    return linear_rows(params.down, y, d_inner)


def mlstm_parallel(params: MLSTM, x, *, n_heads: int, return_state: bool = False):
    """x [B, S, dim] -> y [B, S, dim] (quadratic parallel form).
    With return_state, also returns the recurrent (C, n, m) state after S
    steps (equivalent to running mlstm_decode S times)."""
    B, S, dim = x.shape
    _no_state_on_a_mesh(params, return_state)
    q, k, v, i_pre, f_pre, gate, Cl, P = _mlstm_qkvif(params, x, n_heads)
    logf = F.logsigmoid(f_pre)                                          # [B, S, H]
    Fc = torch.cumsum(logf, dim=1)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]   # [B,t,s,H]
    dmat = dmat.masked_fill(~_causal(S, x.device), float("-inf"))
    m = torch.amax(dmat, dim=2, keepdim=True)                           # [B,t,1,H]
    w = torch.exp(dmat - m)                                             # [B,t,s,H]
    acc = acc_dtype(x)
    qk = torch.einsum("bthp,bshp->btsh", q.to(acc), k.to(acc))
    cmat = w * qk
    num = torch.einsum("btsh,bshp->bthp", cmat, v.to(acc))
    denom = torch.maximum(torch.abs(torch.sum(cmat, dim=2)), torch.exp(-m[:, :, 0, :]))
    y = (num / denom[..., None]).reshape(B, S, Cl).to(x.dtype)
    out = _mlstm_out(params, y, gate)
    if return_state:
        # state after step S: decay of entry s is F_S - F_s + i_s
        d_end = Fc[:, -1:, :] - Fc + i_pre                              # [B, S, H]
        m_T = torch.amax(d_end, dim=1)                                  # [B, H]
        w = torch.exp(d_end - m_T[:, None, :])                          # [B, S, H]
        kf, vf = k.to(acc), v.to(acc)
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
    _no_state_on_a_mesh(params, return_state)
    q, k, v, i_pre, f_pre, gate, Cl, P = _mlstm_qkvif(params, x, n_heads)
    nc, L, H, Pv = S // chunk, chunk, q.shape[2], v.shape[3]

    def rc(t):                                   # [B,S,...] -> [nc,B,L,...]
        return torch.movedim(t.reshape(B, nc, L, *t.shape[2:]), 1, 0)

    acc = acc_dtype(x)
    qc, kc, vc = rc(q.to(acc)), rc(k.to(acc)), rc(v.to(acc))
    ic, fc = rc(i_pre), rc(F.logsigmoid(f_pre))
    causal = _causal(L, x.device)
    C_p = torch.zeros((B, H, P, Pv), dtype=acc, device=x.device)
    n_p = torch.zeros((B, H, P), dtype=acc, device=x.device)
    m_p = torch.full((B, H), float("-inf"), dtype=acc, device=x.device)
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
    y = torch.stack(ys, dim=1).reshape(B, S, Cl).to(x.dtype)
    out = _mlstm_out(params, y, gate)
    if return_state:
        return out, {"C": C_p, "n": n_p, "m": m_p}
    return out


def _no_state_on_a_mesh(params: MLSTM, return_state: bool):
    if return_state and params.wq.w.shape[1] < params.wq.w.shape[0]:
        raise ValueError("return_state takes the whole weights; on a mesh decode "
                         "carries the state (mlstm_decode)")


def make_mlstm_state(batch: int, dim: int, n_heads: int, *, expand: int = 2,
                     device="cpu"):
    d_inner = expand * dim
    P = d_inner // n_heads
    return {"C": torch.zeros((batch, n_heads, P, P), dtype=f32, device=device),
            "n": torch.zeros((batch, n_heads, P), dtype=f32, device=device),
            "m": torch.full((batch, n_heads), float("-inf"), dtype=f32, device=device)}


def mlstm_decode(params: MLSTM, x, state, *, n_heads: int):
    """One-token recurrent step. x [B, 1, dim] -> (y, new state). On a mesh
    the state's ``C`` and ``n`` may hold this rank's block of the key dim
    (module docstring)."""
    B, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    d_inner, P, Cl, _, _ = _mlstm_local(params, n_heads)
    xi, gate = _mlstm_up(params, x, d_inner)
    q, k, v = (linear(w, xi) for w in (params.wq, params.wk, params.wv))
    if Cl < d_inner:
        q, k, v = col.gather(torch.stack([q, k, v], dim=2), "model", -1).unbind(2)
    q, k, v = (t[:, 0].reshape(B, n_heads, P) for t in (q, k, v))          # [B, H, P]
    k = k / (P ** 0.5)
    i_pre = linear(params.wi, xi)[:, 0].to(f32)                         # [B, H]
    f_pre = linear(params.wf, xi)[:, 0].to(f32)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_sc = torch.exp(logf + state["m"] - m_new)
    i_sc = torch.exp(i_pre - m_new)
    qf = q.to(f32)
    Pk = state["C"].shape[2]                 # the key rows of the memory this rank holds
    if Pk < P:
        lo = col.index("model") * Pk
        k, qf = k[..., lo:lo + Pk], qf[..., lo:lo + Pk]
    C = state["C"] * f_sc[..., None, None] + i_sc[..., None, None] * (
        k[..., :, None] * v[..., None, :])                              # [B,H,Pk,P]
    n = state["n"] * f_sc[..., None] + i_sc[..., None] * k
    num = torch.einsum("bhpq,bhp->bhq", C, qf)
    den = torch.sum(n * qf, dim=-1)
    if Pk < P:                               # partial over the key dim: one sum
        tot = col.psum(torch.cat([num, den[..., None]], dim=-1), "model")
        num, den = tot[..., :P], tot[..., P]
    den = torch.maximum(torch.abs(den), torch.exp(-m_new))
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
        self.hidden = hid
        for g in self.GATES:
            setattr(self, g, GateBlock(dim, n_heads, **kw))
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.ff_up = Linear(dim, hid, **kw)
        self.ff_dn = Linear(hid, dim, **kw)


def _slstm_gate(gp: GateBlock, wx_t, h_prev):
    """wx_t [B, dim] (precomputed W·x), h_prev [B, H, P] -> pre-act [B, dim]."""
    B = wx_t.shape[0]
    acc = h_prev.dtype                     # the state's: f32, or f64 in a reference run
    rec = torch.einsum("bhp,hpq->bhq", h_prev, gp.r.to(acc)).reshape(B, -1)
    return wx_t.to(acc) + rec


def make_slstm_state(batch: int, dim: int, n_heads: int, *, dtype=f32, device="cpu"):
    P = dim // n_heads
    sh = (batch, n_heads, P)
    return {"c": torch.zeros(sh, dtype=dtype, device=device),
            "n": torch.full(sh, 1e-6, dtype=dtype, device=device),
            "h": torch.zeros(sh, dtype=dtype, device=device),
            "m": torch.zeros(sh, dtype=dtype, device=device)}


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
    if params.ff_up.w.shape[1] < params.hidden:       # a column block of the hidden width
        h = col.copy(h, "model")
    return linear_rows(params.ff_dn, F.gelu(linear(params.ff_up, h), approximate="tanh"),
                       params.hidden)


def slstm_scan(params: SLSTM, x, *, n_heads: int, return_state: bool = False):
    """x [B, S, dim] -> y [B, S, dim], sequential over S; the four input
    projections run batched over every position before the loop. (The
    reference's two-level scan and remat only shape its backward pass.)"""
    B, S, dim = x.shape
    wx = {g: linear(getattr(params, g).w, x) for g in SLSTM.GATES}     # [B, S, dim]
    state = make_slstm_state(B, dim, n_heads, dtype=acc_dtype(x), device=x.device)
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
    """One-token step. x [B, 1, dim] -> (y, new state). On a mesh the state
    may hold this rank's block of each head's P: the blocks are gathered,
    the step runs whole and the rank keeps its block of the new state."""
    B, S, dim = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    wx_t = {g: linear(getattr(params, g).w, x[:, 0]) for g in SLSTM.GATES}
    keys = ("c", "n", "h", "m")
    split = state["h"].shape[2] < dim // n_heads
    if split:
        whole = col.gather(torch.stack([state[k] for k in keys], dim=1), "model", -1)
        state = dict(zip(keys, whole.unbind(1), strict=True))
    new = _slstm_step(params, state, wx_t, n_heads)
    h = new["h"].reshape(B, 1, dim).to(x.dtype)
    if split:
        new = {k: col.block(v, "model", 2).contiguous() for k, v in new.items()}
    return _slstm_out(params, h), new
