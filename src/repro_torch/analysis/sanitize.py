"""Run-time sanitizer for the port's twins (port of
``repro/analysis/sanitize.py``).

The reference wraps its jitted twin entry points
(``vecenv.rollout``/``vec_rollout``, ``runtime_vec.vec_rollout``/``replay``)
in ``jax.experimental.checkify``, so a NaN, a division by zero or an
out-of-bounds gather surfaces as a typed error at the offending op instead
of as silent reward drift. Here the same entry points run, while the
sanitizer is on, under a ``TorchDispatchMode`` that looks at every aten op:

- ``index``: before a gather, scatter, index, index_put, index_select,
  embedding or take, every index must lie in range (``[0, n)``, or
  ``[-n, n)`` where the op wraps negative indices). The check runs before
  the op because an out-of-range index on a CUDA tensor is a device-side
  assert, which poisons the context. A subscript that torch reads to the
  host (an int or a 0-d tensor) is bounds-checked by torch there, and its
  ``IndexError`` is raised as the sanitizer's;
- ``div``: before an integer division, floor division or remainder, no
  divisor may be zero;
- ``nan``: after the op, no floating output may hold a NaN (views and the
  uninitialised ``empty`` factories excepted).

A failed check raises ``SanitizerError`` naming the op, with "nan",
"division by zero" or "out-of-bounds" in its message. Each check reads one
flag back from the device, so a sanitized call is slow; a replayed CUDA
graph would bypass the dispatcher, so the runtime twin runs its eager event
loop while the sanitizer is on.

Off by default. Enable with either:

- the environment flag ``REPRO_CHECKIFY=1`` (also ``true``/``on``/``yes``); or
- programmatically: ``sanitize.enable()``, ``with sanitize.enabled_scope():``
  or ``Session(..., debug_checkify=True)``.

The programmatic override wins over the environment in both directions.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

# NaN production, integer division by zero and out-of-range indices: the
# three ways a twin quietly stops matching its reference.
ERRORS = frozenset({"nan", "div", "index"})

# The set the reference gives the runtime twin's entry points (its
# checkify could not transform the twin's batched index updates).
NAN_DIV_ERRORS = frozenset({"nan", "div"})

ENV_FLAG = "REPRO_CHECKIFY"

_OVERRIDE: bool | None = None

aten = torch.ops.aten

# (self, dim, index, ...): every index in [0, n) along dim
_DIM_INDEX_OPS = {aten.gather, aten.scatter, aten.scatter_, aten.scatter_add,
                  aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
                  aten.index_select, aten.index_add, aten.index_add_,
                  aten.index_copy, aten.index_copy_, aten.index_fill, aten.index_fill_}
# (self, indices, ...): advanced indexing, negative indices wrap
_LIST_INDEX_OPS = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}
_DIV_OPS = {aten.div, aten.div_, aten.floor_divide, aten.floor_divide_, aten.remainder,
            aten.remainder_, aten.fmod, aten.fmod_}
# outputs whose values are not computed: uninitialised memory
_NO_VALUES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
              aten.new_empty_strided}


class SanitizerError(RuntimeError):
    """A sanitized twin produced a NaN, divided an integer by zero or
    indexed out of range."""


def enabled() -> bool:
    """Is the sanitizer active? Programmatic override first, then env."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    return os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "on", "yes")


def enable(on: bool | None = True) -> None:
    """Force the sanitizer on/off; ``enable(None)`` restores env control."""
    global _OVERRIDE
    _OVERRIDE = on


@contextlib.contextmanager
def enabled_scope(on: bool = True):
    """Temporarily force the sanitizer on (or off) for a block."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = on
    try:
        yield
    finally:
        _OVERRIDE = prev


def _in_range(func, index, size: int, *, wrap: bool, dim: int):
    if index.numel() == 0:
        return
    lo = -size if wrap else 0
    bad = (index < lo) | (index >= size)
    if bool(bad.any()):
        first = int(index[bad].flatten()[0])
        raise SanitizerError(f"out-of-bounds index {first} for dim {dim} of size {size} "
                             f"in {func}")


def _check_index(func, args, kwargs):
    packet = func.overloadpacket
    if packet in _DIM_INDEX_OPS:
        self, dim, index = args[0], args[1], args[2]
        dim = dim % max(self.dim(), 1)
        _in_range(func, index, self.shape[dim] if self.dim() else 1, wrap=False, dim=dim)
    elif packet in _LIST_INDEX_OPS:
        self, indices = args[0], args[1]
        dim = 0
        for index in indices:
            if index is None:
                dim += 1
            elif index.dtype in (torch.bool, torch.uint8):
                dim += index.dim()          # a mask: torch checks its shape
            else:
                _in_range(func, index, self.shape[dim], wrap=True, dim=dim)
                dim += 1
    elif packet is aten.embedding:
        _in_range(func, args[1], args[0].shape[0], wrap=False, dim=0)
    elif packet is aten.take:
        _in_range(func, args[1], args[0].numel(), wrap=True, dim=0)


def _integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int)


def _check_div(func, args, kwargs):
    if func.overloadpacket not in _DIV_OPS or len(args) < 2:
        return
    num, den = args[0], args[1]
    if func.overloadpacket in (aten.div, aten.div_) and kwargs.get("rounding_mode") is None:
        return                              # true division: a float result
    if not (_integral(num) and _integral(den)):
        return
    zero = bool((den == 0).any()) if isinstance(den, torch.Tensor) else den == 0
    if zero:
        raise SanitizerError(f"integer division by zero in {func}")


def _check_nan(func, out):
    if func.is_view or func.overloadpacket in _NO_VALUES:
        return
    for t in _pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise SanitizerError(f"nan produced by {func}")


class _Checks(TorchDispatchMode):
    """Checks each aten op of the block it is active in (see the module
    docstring)."""

    def __init__(self, errors):
        super().__init__()
        self.errors = errors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "index" in self.errors:
            _check_index(func, args, kwargs)
        if "div" in self.errors:
            _check_div(func, args, kwargs)
        out = func(*args, **kwargs)
        if "nan" in self.errors:
            _check_nan(func, out)
        return out


def _active() -> bool:
    return any(isinstance(m, _Checks) for m in _get_current_dispatch_mode_stack())


def checked(fn=None, *, errors=None):
    """Wrap a twin entry point with the sanitizer.

    When the sanitizer is off (the default) the wrapper is a passthrough:
    ``fn`` runs untouched. When on, the call runs under the checking
    dispatch mode with ``errors`` (default ``ERRORS``) and raises
    ``SanitizerError`` at the first NaN, integer division by zero or
    out-of-bounds index anywhere in the episode. Nested calls (e.g.
    ``rollout`` calling ``vec_rollout``) short-circuit to the raw function:
    the outermost entry's mode already checks them."""
    if fn is None:
        return functools.partial(checked, errors=errors)
    error_set = ERRORS if errors is None else frozenset(errors)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not enabled() or _active():
            return fn(*args, **kwargs)
        with _Checks(error_set):
            try:
                return fn(*args, **kwargs)
            except IndexError as e:
                # an index torch reads to the host (a 0-d tensor or an int
                # subscript) is bounds-checked there, before any device work
                if "index" not in error_set:
                    raise
                raise SanitizerError(f"out-of-bounds index: {e}") from e

    wrapper.__wrapped__ = fn
    return wrapper
