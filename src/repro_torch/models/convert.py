"""Carry the reference's weights and caches across (no JAX counterpart).

The reference's parameter pytree arrives as nested dicts of NumPy arrays,
what ``jax.tree.map(np.asarray, params)`` gives; this module never imports
jax. Layer leaves are stacked on a leading [L, ...] axis there and are
unstacked into the port's ``layers`` ModuleList here; a Python list of
subtrees (the policy's ``heads``, a ResMLP's ``blocks``) fills a ModuleList
entry by entry. Linear weights keep the reference's [in, out] layout, so no
leaf is transposed. The same walk carries the dense, audio (whisper, layers
stacked) and ssm (xLSTM, a list of unlike layers) families.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _as_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))    # a writable copy: JAX's views are read-only


def _load(module: nn.Module, tree: dict, prefix: str, loaded: set):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            child = getattr(module, key)
            if isinstance(child, nn.ModuleList):
                for i, sub in enumerate(child):
                    _load(sub, {k: _index(v, i) for k, v in val.items()},
                          f"{name}.{i}.", loaded)
            else:
                _load(child, val, f"{name}.", loaded)
            continue
        if isinstance(val, (list, tuple)):
            child = getattr(module, key)
            if len(child) != len(val):
                raise ValueError(f"{name}: reference has {len(val)} entries, "
                                 f"port has {len(child)}")
            for i, (sub, subtree) in enumerate(zip(child, val)):
                _load(sub, subtree, f"{name}.{i}.", loaded)
            continue
        param = getattr(module, key, None)
        if not isinstance(param, torch.Tensor):
            raise KeyError(f"reference leaf {name!r} has no parameter in the port")
        src = _as_tensor(val)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)} != "
                             f"port shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(src)
        loaded.add(name)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Fill ``model``'s parameters in place from the reference pytree
    ``params`` (nested dicts of NumPy arrays). Every parameter of the model
    must be covered and every leaf must land; returns ``model``."""
    loaded: set[str] = set()
    _load(model, params, "", loaded)
    missing = {n for n, _ in model.named_parameters()} - loaded
    if missing:
        raise KeyError(f"parameters not in the reference pytree: {sorted(missing)}")
    return model


def cache_from_numpy(cache, *, device="cpu"):
    """A reference cache as NumPy arrays -> the port's cache of tensors on
    ``device``, with the same nesting: the dense family's ``k``/``v``
    [L, B, C, kv, hd], whisper's ``ck``/``cv`` besides, the xLSTM's list of
    per-layer state dicts, and ``pos`` [B] as int32."""
    if isinstance(cache, dict):
        return {k: (torch.from_numpy(np.array(v, dtype=np.int32)).to(device)
                    if k == "pos" else cache_from_numpy(v, device=device))
                for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [cache_from_numpy(v, device=device) for v in cache]
    return _as_tensor(cache).to(device)
