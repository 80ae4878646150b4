"""Top-k mixture-of-experts with capacity-bounded gather dispatch. Port of
``repro/nn/moe.py``.

Dispatch gathers, per expert, its top-C tokens by gate (``_route``), runs
the SwiGLU FFN on the stacked expert weights ``[E_phys, d, f]`` and adds
the gated outputs back in float32 (``_dispatch_compute_combine``): ``[E,
C]`` indices and ``[E, C, d]`` activations, never a one-hot ``[T, E, C]``
dispatch tensor. The combine is ``kernels.ops.moe_combine``: each token
adds the gated rows of the slots it holds (``_slot_of``), in ascending
expert order in float32, one writer an output element and no atomics, so
the card gives the same bits on every run; on a CUDA tensor the
hand-written kernel, which reads only the slots that hold a token.

Under a running mesh (``distributed.collectives``) a rank holds the block
of the stacked experts that the rules give it, read off the weights'
shapes, and runs the reference's ``shard_map`` bodies:

  * expert parallel (``wg`` holds E_phys/M experts): route the rank's
    batch rows on the whole (replicated) router, keep the plan's rows of
    the local experts, gather, FFN and scatter shard-locally, then one f32
    ``psum`` over "model". A 100B+ model's train/prefill blocks are also
    split over "data" (FSDP) and are gathered first;
  * ``ep2d`` (decode of a 100B+ model: E over "model", d_ff over "data"):
    the activations are gathered over the batch axes so every rank routes
    the whole batch, the partial sums go through one ``psum`` over
    ("model", "data"), and the rank keeps its rows;
  * fewer experts than the model axis: d_ff over "model" in every expert,
    then ``psum`` over "model".

The aux loss is the reference's over the whole batch: its sums are added
over the batch axes. Under grad the tokens and gates enter the rank's
experts through ``collectives.copy`` and the FSDP blocks' gather is
followed by one over the batch axes, so every gradient, the router's
included, is the one-rank program's (``distributed.collectives``).

Experts >= 16 are padded to a multiple of 16 (``_phys_experts``), as the
reference lays its leaves out; the router stays at the logical E, so a
padded expert is never routed to.

Tie order: ``jax.lax.top_k`` puts the lower index first among equal
values. Equal non-zero gates occur whenever identical tokens pick one
expert, and then the index decides which token keeps its capacity slot, so
both selections here are a stable descending sort (``_top_k``), which
keeps that order; ``torch.topk`` promises none. Routing is discontinuous:
a choice near a tie (a token's k-th and (k+1)-th expert, or the capacity
between tokens equal up to rounding, as in a row of one repeated token,
where attention over equal values gives equal outputs up to the last bit)
turns on the last bits of the hidden state, which two implementations, or
two attention paths, do not round alike. Nothing reads back to the host:
the capacity C is a Python int from the shapes, so a decode step can be
captured in a CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tracing
from repro_torch.distributed import collectives as col
from repro_torch.kernels import ops
from repro_torch.nn.linear import Linear, _normal


def _phys_experts(n_experts: int) -> int:
    """Experts >= 16 are padded to a multiple of 16 (the reference's mesh
    model axis)."""
    return n_experts if n_experts < 16 else 16 * math.ceil(n_experts / 16)


class Experts(nn.Module):
    """Stacked SwiGLU expert weights: ``wg``/``wu`` [E, d, f], ``wd`` [E, f, d],
    lecun-normal per expert, as the reference's vmapped ``init_linear``."""

    def __init__(self, dim: int, hidden: int, n_experts: int, *, dtype=torch.float32,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wg = _normal((n_experts, dim, hidden), std=dim ** -0.5, **kw)
        self.wu = _normal((n_experts, dim, hidden), std=dim ** -0.5, **kw)
        self.wd = _normal((n_experts, hidden, dim), std=hidden ** -0.5, **kw)


class MoE(nn.Module):
    """``router`` (float32, ``[d, E]``) and ``experts`` (``E_phys`` stacked)."""

    def __init__(self, dim: int, hidden: int, n_experts: int, *, dtype=torch.float32,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.experts = Experts(dim, hidden, _phys_experts(n_experts), dtype=dtype,
                               device=device, generator=generator)
        self.router = Linear(dim, n_experts, dtype=torch.float32, device=device,
                             generator=generator)


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(params: MoE, x):
    """The router's softmax [B, S, E] over the logical experts, in f32."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          params.router.w.to(torch.float32))
    return torch.softmax(logits, dim=-1)


def gates_of(probs, top_e, E_phys: int):
    """Gates [B, S, E_phys]: each token's ``top_e`` [B, S, k] choices
    weighted by their renormalised probabilities (a one-hot sum over the k
    choices, as in the reference)."""
    top_p = torch.gather(probs, -1, top_e)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    experts = torch.arange(E_phys, device=probs.device)
    onehot = top_e[..., None] == experts                                  # [B,S,k,E+]
    return torch.einsum("bsk,bske->bse", top_p, onehot.to(torch.float32))


def _route(params: MoE, x, *, top_k: int, capacity_factor: float, E_phys: int):
    """Router + per-(row, expert) top-C dispatch plan -> gsel/tok_idx
    [B, E_phys, C], probs [B, S, E] and C. ``gsel`` and ``probs`` carry the
    router's gradient; the choices (``top_e``, ``tok_idx``) take none."""
    S = x.shape[1]
    E = params.router.w.shape[1]
    probs = router_probs(params, x)
    _, top_e = _top_k(probs, top_k)                                       # [B,S,k]
    gates = gates_of(probs, top_e, E_phys)
    C = max(1, min(S, int(capacity_factor * S * top_k / E)))
    gsel, tok_idx = _top_k(gates.transpose(1, 2), C)                      # [B,E+,C]
    return gsel, tok_idx, probs, C


def _expert_ffn(xe, wg, wu, wd):
    """xe [B, E, C, d] with stacked expert weights [E, d, f] / [E, f, d]."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg))
    h = h * torch.einsum("becd,edf->becf", xe, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def _slot_of(tok_idx, gsel, S: int):
    """The combine's index [B, E, S] int32: the slot c that token s holds in
    expert e (``tok_idx[b, e, c] == s`` with a gate > 0), or -1. An expert's C
    tokens are distinct, so the one scatter collides nowhere."""
    B, E, C = tok_idx.shape
    slots = torch.arange(C, dtype=torch.int32, device=tok_idx.device).expand(B, E, C)
    out = torch.full((B, E, S), -1, dtype=torch.int32, device=tok_idx.device)
    return out.scatter_(2, tok_idx, torch.where(gsel > 0, slots, -1))


def _dispatch_compute_combine(x, gsel, tok_idx, wg, wu, wd, *, out_dtype=None):
    """Gather tokens per expert, run the FFN, add the gated outputs back.
    x [B, S, d]; gsel/tok_idx [B, E, C] -> y [B, S, d] in ``out_dtype``
    (default x's dtype), summed in float32.

    The reference scatter-adds; here each token adds its own slots in
    ascending expert order (``kernels.ops.moe_combine``)."""
    S = x.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    xe = x[rows, tok_idx]                                                 # [B,E,C,d]
    ye = _expert_ffn(xe, wg.to(xe.dtype), wu.to(xe.dtype), wd.to(xe.dtype))
    return ops.moe_combine(ye, gsel.contiguous(), _slot_of(tok_idx, gsel, S),
                           out_dtype=out_dtype)


def _aux(gsel, probs, E: int):
    """Switch-style load-balance loss + dropped-token fraction. The demand
    is ``B * S * probs.shape[-1]`` slots, which the reference writes as
    B·S·E (its comment says B·S·k). The slots computed and those holding a
    token go to ``tracing.count_moe``."""
    B, S, _ = probs.shape
    used = (gsel > 0).to(torch.float32)                                   # [B,E+,C]
    total = used.sum()
    tracing.count_moe(used.numel(), total)
    frac_tokens = used.sum(dim=(0, 2))[:E] / torch.clamp(total, min=1.0)
    frac_probs = torch.mean(probs, dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    dropped = 1.0 - total / max(B * S * probs.shape[-1], 1)
    return {"lb_loss": lb_loss, "dropped_frac": torch.clamp(dropped, 0.0, 1.0)}


def _aux_sharded(gsel, probs, E: int, axes):
    """``_aux`` over the whole batch when the rows are split over ``axes``:
    the counts and probability sums are added across the ranks first."""
    B, S, _ = probs.shape
    used = (gsel > 0).to(torch.float32)
    sums = col.psum(torch.cat([used.sum(dim=(0, 2))[:E], used.sum()[None],
                               probs.sum(dim=(0, 1)),
                               torch.full((1,), float(B * S), device=probs.device)]), axes)
    per_e, total, psum_e, n = sums[:E], sums[E], sums[E + 1:2 * E + 1], sums[-1]
    lb_loss = E * torch.sum(per_e / torch.clamp(total, min=1.0) * (psum_e / n))
    dropped = 1.0 - total / torch.clamp(n * probs.shape[-1], min=1.0)
    return {"lb_loss": lb_loss, "dropped_frac": torch.clamp(dropped, 0.0, 1.0)}


def moe(params: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
        need_aux: bool = True, ep2d: bool = False):
    """x [B, S, d] -> (y [B, S, d] in x's dtype, aux). A decode step passes
    ``need_aux=False`` and gets ``aux=None``: the reference computes the aux
    there and drops it, which XLA elides and eager PyTorch would not.
    ``ep2d`` (the decode of a 100B+ model) takes the two-axis path when the
    rank's experts are split so (module docstring)."""
    E = params.router.w.shape[1]
    w = params.experts
    E_phys = _phys_experts(E)
    wg, wu, wd = w.wg, w.wu, w.wd
    sharded = wg.shape[0] < E_phys or wg.shape[2] < params.hidden
    if col.current_mesh() is None or not sharded:
        gsel, tok_idx, probs, _ = _route(params, x, top_k=top_k,
                                         capacity_factor=capacity_factor, E_phys=E_phys)
        y = _dispatch_compute_combine(x, gsel, tok_idx, wg, wu, wd)
        return y, (_aux(gsel, probs, E) if need_aux else None)
    bax = col.batch_axes()
    two_d = ep2d and wg.shape[0] < E_phys and wg.shape[2] < params.hidden
    if wg.shape[1] < x.shape[-1]:            # FSDP blocks of a 100B+ train/prefill
        # each data rank applies the whole experts to its own rows: the
        # gradient is summed over the batch axes, then blocked
        wg, wu, wd = (col.copy(col.gather(w_, "data", 1), bax) for w_ in (wg, wu, wd))
    xr = col.gather(x, bax, 0) if two_d and bax else x
    gsel, tok_idx, probs, _ = _route(params, xr, top_k=top_k,
                                     capacity_factor=capacity_factor, E_phys=E_phys)
    El = wg.shape[0]
    e0 = col.index("model") * El if El < E_phys else 0
    group = ("model", "data") if two_d else "model"
    # the rank's experts (or d_ff block) use the tokens and gates in their
    # own way: both pass through copy, so their gradients sum over the group
    # the psum adds the ranks' partial sums in float32
    acc = torch.promote_types(x.dtype, torch.float32)
    y = _dispatch_compute_combine(col.copy(xr, group), col.copy(gsel, group)[:, e0:e0 + El],
                                  tok_idx[:, e0:e0 + El], wg, wu, wd, out_dtype=acc)
    y = col.psum(y, group)
    if two_d and bax:
        y = col.block(y, bax, 0)
    aux = None
    if need_aux:
        aux = (_aux_sharded(gsel, probs, E, bax) if bax and not two_d
               else _aux(gsel, probs, E))
    return y.to(x.dtype), aux
