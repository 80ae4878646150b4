"""The sharded program's collectives over a running mesh's axes: the
counterpart of ``shard_map``'s ``psum`` and of the gathers GSPMD inserts.

    with use_mesh(mesh, **sharding.program_axes(cfg, shape, mesh)):
        logits, aux = api.forward(model, batch, cfg)

``use_mesh`` makes ``mesh`` the ambient mesh (the reference's
``use_mesh``): the layers read it to know which block of each weight they
hold and where a partial sum must be reduced. ``batch_axes`` names the
axes the batch rows are split over, empty when every rank holds the whole
batch; ``cache_axes`` the axes a decode cache's length is split over (the
weights' blocks are read off their shapes, but a block of rows or slots
cannot tell whether it is the whole). Outside ``use_mesh``, or on a mesh of one
rank, every function here is the identity and the layers run the
single-device program.

Every collective is an ``all_reduce``, SUM or MAX, because gloo offers
nothing else on CUDA tensors. ``gather`` is a ``psum`` of a zero-filled
full buffer into which each rank has written its block, which is exact
(every element is a sum of one value and zeros). Inputs are never
modified.

Gradients. ``psum``, ``copy``, ``gather`` and ``block`` are
``torch.autograd.Function``s whose backward is their SPMD transpose under
one convention: a tensor every rank of a group holds alike (replicated)
has, on every rank, the whole gradient of the loss, and a rank's block has
its block of it. So

  * ``psum`` (partial sums -> replicated: a row-parallel output, Megatron's
    "g") is the identity backward;
  * ``copy`` (replicated -> used by each rank in its own way: the input of
    a column-parallel layer, of the local experts, of a vocab block of the
    ``lm_head``; Megatron's "f") is the identity forward and a ``psum``
    backward, which adds the ranks' parts of the gradient;
  * ``gather`` (a sequence or width block -> replicated) keeps the rank's
    block of the gradient; where the gathered tensor is used in a
    rank-dependent way (the 100B+ experts' FSDP blocks, gathered over
    "data" and applied to the rank's batch rows) a ``copy`` follows it, so
    the backward is a sum, then the block;
  * ``block`` (replicated -> the rank's block: ``shard_h``'s sequence
    block) gathers the gradient's blocks backward.

``pmax`` takes no gradient (the decode merge's and the loss's row max,
which shifts a softmax and cancels out). The layers place a ``copy`` only
where their weights are blocks, so a program whose weights are all whole
takes no collective in either pass. Each rank differentiates its own loss
term; the train step then sums the gradients over the data axes
(``models.steps``).

``counting()`` counts, per device, the bytes the calls inside it move,
the backward's collectives included: an
``all_reduce`` of n bytes over a group of g ranks moves 2·(g-1)/g·n bytes
in and out of each device (a ring: reduce-scatter, then all-gather), the
figure the dry run's collective term divides by a link's bandwidth. It is
kept per group (``Count.by_group``), so the dry run can price each group
by the slowest link it spans.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

_state: dict = {"mesh": None, "batch_axes": (), "cache_axes": ()}
_counts: list = []


@dataclass
class Count:
    """Collective traffic counted inside ``counting()``: group axes (a
    tuple) -> bytes moved per device."""
    by_group: dict = field(default_factory=dict)


@contextlib.contextmanager
def use_mesh(mesh, *, batch_axes=(), cache_axes=()):
    """Make ``mesh`` the ambient mesh of the sharded program (module
    docstring)."""
    saved = dict(_state)
    _state.update(mesh=mesh, batch_axes=tuple(batch_axes or ()),
                  cache_axes=tuple(cache_axes or ()))
    try:
        yield mesh
    finally:
        _state.update(saved)


def current_mesh():
    """The ambient mesh when it runs more than one rank, else None."""
    mesh = _state["mesh"]
    return mesh if mesh is not None and mesh.running else None


def batch_axes() -> tuple[str, ...]:
    """The axes the ambient program's batch is split over."""
    return _state["batch_axes"] if current_mesh() is not None else ()


def cache_axes() -> tuple[str, ...]:
    """The axes the ambient program's decode cache length is split over."""
    return _state["cache_axes"] if current_mesh() is not None else ()


def span(axes) -> int:
    """Ranks in the ambient mesh's group over ``axes`` (1 off a mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.span(axes)


def index(axes) -> int:
    """This rank's index in the group over ``axes`` (0 off a mesh)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index(axes)


@contextlib.contextmanager
def counting():
    """Count the collective bytes of the calls inside (module docstring)."""
    c = Count()
    _counts.append(c)
    try:
        yield c
    finally:
        _counts.remove(c)


def _all_reduce(x: torch.Tensor, mesh, names: tuple, op) -> torch.Tensor:
    """A new tensor: ``x`` all-reduced over the group of ``names``, counted."""
    import torch.distributed as dist
    y = x.clone()
    dist.all_reduce(y, op=op, group=mesh.group(names))
    g = mesh.span(names)
    moved = 2.0 * (g - 1) / g * y.numel() * y.element_size()
    for c in _counts:
        c.by_group[names] = c.by_group.get(names, 0.0) + moved
    return y


def _group(axes):
    """(mesh, axis names) of the ambient group over ``axes``, or None when
    it is one rank (every collective over it is then the identity)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    names = mesh.axes(axes)
    return (mesh, names) if mesh.span(names) > 1 else None


def _sum(x, mesh, names):
    import torch.distributed as dist
    return _all_reduce(x, mesh, names, dist.ReduceOp.SUM)


def _narrow(x, mesh, names, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.span(names)
    return x.narrow(dim, mesh.index(names) * n, n)


def _widen(x, mesh, names, dim: int) -> torch.Tensor:
    """The whole tensor of the blocks ``x`` along ``dim``: a zero-filled
    full buffer holding this rank's block, summed over the group."""
    n = x.shape[dim]
    full = x.new_zeros(x.shape[:dim] + (n * mesh.span(names),) + x.shape[dim + 1:])
    full.narrow(dim, mesh.index(names) * n, n).copy_(x)
    return _sum(full, mesh, names)


class _Psum(torch.autograd.Function):
    """Sum forward (partial -> replicated); identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        return _sum(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """Identity forward; sum backward (replicated -> used differently by
    each rank, so each rank's gradient is one part of the whole)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.group = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), *ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Gather forward (block -> replicated); the rank's block of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.group, ctx.dim = (mesh, names), dim
        return _widen(x, mesh, names, dim)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, *ctx.group, ctx.dim).contiguous(), None, None, None


class _Block(torch.autograd.Function):
    """The rank's block forward (replicated -> block); the gradient's
    blocks gathered backward."""

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.group, ctx.dim = (mesh, names), dim
        return _narrow(x, mesh, names, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _widen(g.contiguous(), *ctx.group, ctx.dim), None, None, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the group over ``axes``; its backward
    is the identity (a row-parallel sum: module docstring)."""
    grp = _group(axes)
    return x if grp is None else _Psum.apply(x, *grp)


def copy(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` itself, for use by each rank of the group over ``axes`` in its
    own way (a column-parallel input); its backward sums the gradient over
    the group."""
    grp = _group(axes)
    return x if grp is None else _Copy.apply(x, *grp)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """Element-wise max of ``x`` over the ranks of the group over ``axes``.
    It takes no gradient: the result is detached."""
    import torch.distributed as dist
    grp = _group(axes)
    return x if grp is None else _all_reduce(x.detach(), *grp, dist.ReduceOp.MAX)


def gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The whole tensor whose block along ``dim`` this rank holds, the
    blocks in the order of the ranks' index over ``axes``; its backward
    keeps the rank's block of the gradient."""
    grp = _group(axes)
    return x if grp is None else _Gather.apply(x, *grp, dim % x.dim())


def block(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (the inverse
    of ``gather``): a view when no gradient is taken, else a tensor whose
    backward gathers the gradient's blocks."""
    grp = _group(axes)
    if grp is None:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Block.apply(x, *grp, dim)
    return _narrow(x, *grp, dim)
