"""One step's flops, bytes and peak memory, counted over the eager program:
the port's counterpart of ``repro/launch/hlo_cost.analyze``.

``hlo_cost`` exists because XLA's ``cost_analysis`` counts a while-loop
body once, so a scanned layer stack under-reports by the trip count. Eager
torch runs every layer's ops one by one, so counting the ops that run
counts every layer: the trip-count problem does not arise, and no HLO is
parsed. ``measure`` runs a step under three counters at once:

- flops: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, SDPA) plus the attention kernels' products, which the
  counter cannot see (a CUDA kernel is called through ctypes). Calls of
  ``kernels.ops.flash_attention`` / ``decode_attention`` are intercepted
  and counted as the CUDA kernels compute them: flash 4·B·H·D per
  unmasked (query, key) pair (S(S+1)/2 pairs causal, the kernel skips
  masked tiles), decode 4·B·H·C·D over the whole cache. The call itself
  then runs hidden from the counters (on the CPU the plain version, whose
  products are not the kernel's); on fake tensors it only allocates its
  output, since the plain version computes the whole [S, S] square;
- ``aten_bytes``: the operand and result bytes summed over every aten op
  that computes (views, uninitialised factories and metadata queries
  excluded; a kernel call counts q, k, v, its mask and its output).
  Unfused, so larger than the reference's fused HLO count;
- ``peak_bytes``: the most bytes of tensor storage live at once during the
  step, the step's inputs included: the eager program's allocation trace,
  without the caching allocator's rounding and fragmentation.

The minimum bytes a step must move, each input read once and each output
written once (``step_bytes`` for a decode step, ``io_bytes`` otherwise), is
the roofline's memory term. ``measure`` also runs on fake tensors
(``FakeTensorMode``), so a step at a size no card holds is counted without
memory: the dry run (``launch/dryrun.py``) counts every (arch, shape) so.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.nn.linear import Embedding

_STATE_KEYS = ("states", "ssm", "conv")    # recurrent state a decode step reads and rewrites
# uninitialised factories, and ``prim.device``: a metadata query (iterating a
# tensor asks it of the whole tensor at every step) moves no bytes
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               torch.ops.prim.device}


@dataclass
class StepCost:
    flops: float = 0.0              # counted products + the attention kernels'
    attention_flops: float = 0.0    # of which the attention kernels' (kernel convention)
    aten_bytes: float = 0.0         # operand + result bytes over aten ops (unfused)
    peak_bytes: float = 0.0         # most storage live at once, inputs included
    calls: dict = field(default_factory=lambda: {"flash_attention": 0,
                                                 "decode_attention": 0})


def tensors(tree):
    """Every tensor in a nest of modules, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def attention_pairs(S: int, *, causal: bool = True, window: int | None = None) -> int:
    """Unmasked (query, key) pairs of an S-token attention."""
    if causal:
        if window is None or window >= S:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    if window is None or window >= S:
        return S * S
    return S * S - (S - window + 1) * (S - window) // 2


def _flat(x) -> list:
    """The tensors among an op's arguments or results (one level of lists)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


class _Memory(TorchDispatchMode):
    """Sums operand and result bytes per aten op and tracks the storage
    live at once (each storage counted from the op that made it until it
    is freed)."""

    def __init__(self):
        super().__init__()
        self.aten_bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, tuple] = {}       # storage key -> (weakref, bytes)

    def track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = (weakref.ref(st, lambda _, key=key: self._free(key)), n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int):
        self.live -= self._refs.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _flat(out)
        for t in outs:
            self.track(t)
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            n = sum(nbytes(t) for t in outs)
            for a in args:
                n += sum(nbytes(t) for t in _flat(a))
            self.aten_bytes += n
        return out


def _fake(t) -> bool:
    return isinstance(t, FakeTensor) or t.device.type == "meta"


@contextlib.contextmanager
def _kernels_counted(cost: StepCost, memory: _Memory):
    """Intercept the attention entry points of ``kernels.ops`` (see the
    module docstring)."""
    saved = ops.flash_attention, ops.decode_attention

    def run(fn, out_like, *args, **kw):
        if _fake(out_like):
            return torch.empty_like(out_like)       # the output's allocation only
        with _disable_current_modes():
            out = fn(*args, **kw)
        memory.track(out)
        return out

    def flash(q, k, v, *, causal=True, window=None):
        B, S, H, D = q.shape
        cost.attention_flops += 4.0 * B * H * D * attention_pairs(S, causal=causal,
                                                                   window=window)
        cost.calls["flash_attention"] += 1
        memory.aten_bytes += nbytes(q) * 2 + nbytes(k) + nbytes(v)
        return run(saved[0], q, q, k, v, causal=causal, window=window)

    def decode(q, k, v, valid_mask, *, return_lse=False):
        B, _, H, D = q.shape
        cost.attention_flops += 4.0 * B * H * k.shape[1] * D
        cost.calls["decode_attention"] += 1
        memory.aten_bytes += nbytes(q) * 2 + nbytes(k) + nbytes(v) + nbytes(valid_mask)
        if not return_lse:
            return run(saved[1], q, q, k, v, valid_mask)
        lse = q.new_empty((B, H), dtype=torch.float32)
        memory.aten_bytes += nbytes(lse)
        if _fake(q):
            return torch.empty_like(q), lse
        with _disable_current_modes():
            out = saved[1](q, k, v, valid_mask, return_lse=True)
        for t in out:
            memory.track(t)
        return out

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def measure(fn, *args, inputs=None):
    """``fn(*args)`` under the counters -> (its output, ``StepCost``).
    ``inputs`` (default ``args``): the tensors that live before the step
    (modules' parameters, dicts and lists of tensors), counted in the peak."""
    cost = StepCost()
    memory = _Memory()
    for t in tensors(args if inputs is None else inputs):
        memory.track(t)
    with FlopCounterMode(display=False) as counter, memory, _kernels_counted(cost, memory):
        out = fn(*args)
    cost.flops = float(counter.get_total_flops()) + cost.attention_flops
    cost.aten_bytes = float(memory.aten_bytes)
    cost.peak_bytes = float(memory.peak)
    return out, cost


def step_bytes(model: torch.nn.Module, cache: dict, batch: int, logits, *,
               valid: int | None = None) -> float:
    """Bytes one decode step must move, each read once and each write once:
    every parameter (only ``batch`` rows of an embedding table); of the
    self-attention KV (``k``/``v`` [L, B, C, kv, hd], zamba's [G, ...]) the
    valid slots read (``min(pos + 1, C)`` per row, summed; or ``valid``, as
    the dry run passes for a cache whose context is consumed: the decode
    kernel skips masked tiles) and the new slot written; the whole
    recurrent state (the xLSTM's ``states``, zamba's ``ssm`` and ``conv``)
    read and written; whisper's cross-attention KV (``ck``/``cv``) read
    whole; and the logits written."""
    tables = [m.e for m in model.modules() if isinstance(m, Embedding)]
    ids = {id(e) for e in tables}
    total = sum(nbytes(p) for p in model.parameters() if id(p) not in ids)
    total += sum(batch * e.shape[1] * e.element_size() for e in tables)
    for key, val in cache.items():
        if key == "pos":
            continue
        for t in tensors(val):
            if key in ("k", "v"):
                slot = nbytes(t) // (t.shape[1] * t.shape[2])     # one row's slot
                n = (int(torch.clamp(cache["pos"] + 1, max=t.shape[2]).sum())
                     if valid is None else valid)
                total += (n + t.shape[1]) * slot
            else:
                total += nbytes(t) * (2 if key in _STATE_KEYS else 1)
    return float(total + nbytes(logits))


def io_bytes(inputs, outputs, *, tokens: int | None = None) -> float:
    """Bytes a step must move when it reads ``inputs`` once and writes
    ``outputs`` once (nests of modules, dicts and tensors); with ``tokens``,
    an input module's embedding tables count only the rows that many
    tokens read."""
    total = 0
    for tree in (inputs, outputs):
        for part in (tree if isinstance(tree, (list, tuple)) else [tree]):
            if isinstance(part, torch.nn.Module) and tokens is not None and tree is inputs:
                tables = {id(m.e): m.e for m in part.modules() if isinstance(m, Embedding)}
                total += sum(nbytes(p) for p in part.parameters() if id(p) not in tables)
                total += sum(min(tokens, e.shape[0]) * e.shape[1] * e.element_size()
                             for e in tables.values())
            else:
                total += sum(nbytes(t) for t in tensors(part))
    return float(total)
