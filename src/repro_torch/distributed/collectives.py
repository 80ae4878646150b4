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

``counting()`` counts, per device, the bytes the calls inside it move: an
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


def _reduce(x: torch.Tensor, axes, op) -> torch.Tensor:
    import torch.distributed as dist
    mesh = current_mesh()
    if mesh is None:
        return x
    names = mesh.axes(axes)
    g = mesh.span(names)
    if g == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=op, group=mesh.group(names))
    moved = 2.0 * (g - 1) / g * y.numel() * y.element_size()
    for c in _counts:
        c.by_group[names] = c.by_group.get(names, 0.0) + moved
    return y


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the group over ``axes``."""
    import torch.distributed as dist
    return _reduce(x, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """Element-wise max of ``x`` over the ranks of the group over ``axes``."""
    import torch.distributed as dist
    return _reduce(x, axes, dist.ReduceOp.MAX)


def gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The whole tensor whose block along ``dim`` this rank holds, the
    blocks in the order of the ranks' index over ``axes``."""
    g = span(axes)
    if g == 1:
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    full = x.new_zeros(x.shape[:dim] + (n * g,) + x.shape[dim + 1:])
    full.narrow(dim, index(axes) * n, n).copy_(x)
    return psum(full, axes)


def block(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view; the
    inverse of ``gather``)."""
    g = span(axes)
    if g == 1:
        return x
    n = x.shape[dim] // g
    return x.narrow(dim, index(axes) * n, n)
