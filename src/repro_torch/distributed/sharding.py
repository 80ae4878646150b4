"""Placement rules: architecture-aware partition entries for params, AdamW
moments, batches and caches (port of ``repro/distributed/sharding.py``).

The reference answers with ``NamedSharding``s on its production mesh; here
a rule answers with the same ``PartitionSpec`` entries as data, one per dim
of each of the port's tensors: ``None`` (whole), an axis name, or a tuple
of axis names. Parameters are keyed by the port's ``named_parameters()``
names (``layers.3.attn.wq.w``); the reference stacks a family's layers on
leading axes (``layers/...`` [L, ...], zamba's ``mamba_layers/...``
[G, k, ...]), which the port's per-layer tensors do not have, so the
stacked dims' entries (always ``None``) are dropped. The rules themselves
are the reference's, on the reference's layer-local paths:

  * batch  -> ("pod", "data") (pure DP across pods)
  * tensor parallel on "model": MLP d_ff, attention heads when
    n_heads % model == 0, the expert dim for MoE when n_experts >= model
    (else the per-expert d_ff), vocab when divisible (else the embedding's
    d_model side)
  * decode KV caches sharded on the cache-length axis; SSM/xLSTM recurrent
    states on heads/state
  * AdamW moments (ZeRO-1): the param's entries plus the data axis on the
    first still-whole dim that divides it

On one card the mesh is (1, 1) (``launch.mesh.make_device_mesh``): every
entry then keeps a tensor whole, and ``place`` puts params, cache and batch
on the card. On a mesh of running ranks (``distributed.launch``) ``place``
keeps in each rank exactly its block of every tensor (``local_block``), so
the bytes ``shard_bytes`` gives per device, which the dry run counts, are
the bytes a running rank holds; the layers then run the sharded program
over those blocks (``distributed.collectives``). ``residual_constraint``
is the reference's sequence-parallel residual stream (``shard_h``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.steps import batch_specs, cache_context


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def replicated(mesh) -> tuple:
    """The entries of a tensor held whole on every device (``P()``)."""
    return ()


def abstract_params(cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """The port's parameters of ``cfg`` by name, as fake tensors (shape and
    dtype, no storage): the model is built under ``FakeTensorMode``, so no
    device memory is touched and no random number drawn for real. The
    dispatch modes around the call are set aside while it builds, so a
    step that asks the rules (the sharded train step) adds nothing to a
    counter it runs under (``launch/step_cost.py``)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes(), FakeTensorMode():
        model = api.init_model(0, cfg, device="cpu")
    return dict(model.named_parameters())


def abstract_cache(cfg: ArchConfig, shape: InputShape):
    """The decode cache of ``shape`` as fake tensors, the structure the
    reference's ``cache_shardings`` walks (``init_cache`` at the cache
    context, at least 1)."""
    with FakeTensorMode():
        return api.init_cache(cfg, shape.global_batch, max(cache_context(cfg, shape), 1),
                              device="cpu")


def reference_path(cfg: ArchConfig, name: str) -> tuple[str, int]:
    """The port's parameter name -> (the reference's leaf path, the number
    of stacked-layer dims the reference has and the port drops):
    ``layers.3.attn.wq.w`` -> (``layers/attn/wq/w``, 1), zamba's
    ``mamba_layers.1.0.mamba.in_x.w`` -> (``mamba_layers/mamba/in_x/w``, 2);
    the xLSTM's layers are a list in both, so their index stays."""
    parts = name.split(".")
    if cfg.family != "ssm":
        if parts[0] == "mamba_layers":
            return "/".join([parts[0]] + parts[3:]), 2
        if parts[0] == "layers":
            return "/".join([parts[0]] + parts[2:]), 1
    return "/".join(parts), 0


def _leaf_rule(cfg: ArchConfig, M: int, path: str, shape: tuple,
               kind: str = "train") -> tuple:
    """PartitionSpec entries for a layer-local param leaf (the reference's
    rule, verbatim). ``kind`` selects the 100B+ expert strategy: train/
    prefill gather FSDP-sharded weights at the shard_map boundary; decode
    keeps the weights resident, two-axis sharded (E x d_ff)."""
    heads_ok = cfg.n_heads % M == 0
    kv_ok = cfg.n_kv % M == 0
    ff_ok = cfg.d_ff % M == 0 if cfg.d_ff else False
    vocab_ok = cfg.vocab % M == 0
    d_inner_ok = (2 * cfg.d_model) % M == 0

    def none(nd):
        return (None,) * nd

    # --- embeddings / head ------------------------------------------------
    if path.endswith("embed/e"):
        return ("model", None) if vocab_ok else (None, "model")
    if path.endswith("pos/e"):
        return (None, "model")
    if path.endswith("lm_head/w"):
        return (None, "model") if vocab_ok else ("model", None)
    if path.endswith("vis_proj/w"):
        return (None, "model")

    # --- attention ---------------------------------------------------------
    if "attn" in path:
        name = path.rsplit("/", 2)[-2]        # .../<proj>/w or /b
        is_cross = "cross_attn" in path
        k_ok = heads_ok if is_cross else kv_ok
        if path.endswith("/w"):
            if name == "wq":
                return (None, "model") if heads_ok else none(2)
            if name in ("wk", "wv"):
                return (None, "model") if k_ok else none(2)
            if name == "wo":
                return ("model", None) if heads_ok else none(2)
        if path.endswith("/b"):
            if name == "wq":
                return ("model",) if heads_ok else none(1)
            if name in ("wk", "wv"):
                return ("model",) if k_ok else none(1)
            return none(1)                    # wo bias

    # --- MoE ----------------------------------------------------------------
    if "experts" in path:
        e_ok = cfg.n_experts >= M
        big = cfg.param_count() > 1e11
        fsdp = "data" if (big and kind != "decode") else None
        ep2d = "data" if (big and kind == "decode") else None
        if path.endswith("wg") or path.endswith("wu"):     # [E, d, ff]
            if e_ok:
                return ("model", fsdp, ep2d)
            return (None, None, "model") if ff_ok else none(3)
        if path.endswith("wd"):                            # [E, ff, d]
            if e_ok:
                return ("model", fsdp or ep2d, None)
            return (None, "model", None) if ff_ok else none(3)
    if "router" in path:
        return none(len(shape))

    # --- dense MLP -----------------------------------------------------------
    if "mlp" in path or "ff_up" in path or "ff_dn" in path:
        if path.endswith(("wg/w", "wu/w", "w1/w", "ff_up/w")):
            return (None, "model") if ff_ok or "ff_up" in path else none(2)
        if path.endswith(("wd/w", "w2/w", "ff_dn/w")):
            return ("model", None) if ff_ok or "ff_dn" in path else none(2)
        if path.endswith("w1/b"):
            return ("model",) if ff_ok else none(1)
        return none(len(shape))

    # --- mamba ----------------------------------------------------------------
    if "mamba" in path:
        if path.endswith(("in_z/w", "in_x/w")):
            return (None, "model") if d_inner_ok else none(2)
        if path.endswith("out_proj/w"):
            return ("model", None) if d_inner_ok else none(2)
        return none(len(shape))

    # --- xlstm -----------------------------------------------------------------
    if "mlstm" in path:
        if path.endswith("up/w"):
            return (None, "model") if d_inner_ok and M % 2 == 0 else none(2)
        if path.endswith(("wq/w", "wk/w", "wv/w")):
            return (None, "model") if d_inner_ok else none(2)
        if path.endswith("down/w"):
            return ("model", None) if d_inner_ok else none(2)
        return none(len(shape))
    if "slstm" in path:
        hid = int(4 / 3 * cfg.d_model)
        if path.endswith("ff_up/w"):
            return (None, "model") if hid % M == 0 else none(2)
        if path.endswith("ff_dn/w"):
            return ("model", None) if hid % M == 0 else none(2)
        return none(len(shape))

    return none(len(shape))


def _entry(axes: tuple):
    """One dim's entry for ``axes``: a single axis by its name, as
    ``PartitionSpec`` normalises a 1-tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _divides(shape, spec, mesh) -> bool:
    sizes = mesh.shape
    for dim, entry in zip(shape, spec, strict=True):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        if dim % n:
            return False
    return True


def param_shardings(cfg: ArchConfig, mesh, *, multi_pod: bool = False,
                    kind: str = "train", params: dict | None = None) -> dict[str, tuple]:
    """Entries per parameter name (``params``: name -> tensor, default
    ``abstract_params(cfg)``); a spec that does not divide falls back to
    whole, as the reference's."""
    M = mesh.shape["model"]
    params = abstract_params(cfg) if params is None else params
    out = {}
    for name, p in params.items():
        path, _ = reference_path(cfg, name)
        spec = tuple(_leaf_rule(cfg, M, path, tuple(p.shape), kind))
        if len(spec) != p.dim():
            raise ValueError(f"{name}: rule {spec} for shape {tuple(p.shape)}")
        out[name] = spec if _divides(p.shape, spec, mesh) else (None,) * p.dim()
    return out


def opt_shardings(cfg: ArchConfig, mesh, *, multi_pod: bool = False,
                  params: dict | None = None) -> dict[str, tuple]:
    """ZeRO-1: each AdamW moment takes its param's entries (train kind)
    plus the data axes on the first still-whole dim they divide."""
    dp = dp_axes(multi_pod)
    sizes = mesh.shape
    params = abstract_params(cfg) if params is None else params
    base = param_shardings(cfg, mesh, multi_pod=multi_pod, params=params)
    out = {}
    for name, p in params.items():
        spec = list(base[name])
        used = {a for s in spec for a in _axes(s)}
        free_dp = tuple(a for a in dp if a not in used)
        free_size = 1
        for a in free_dp:
            free_size *= sizes[a]
        if free_dp:
            for i, dim in enumerate(p.shape):
                if spec[i] is None and dim % free_size == 0 and dim >= free_size:
                    spec[i] = _entry(free_dp)
                    break
        out[name] = tuple(spec) if _divides(p.shape, spec, mesh) else (None,) * p.dim()
    return out


def split_axes(specs: dict[str, tuple]) -> dict[str, tuple[str, ...]]:
    """Entries per name -> every axis the tensor's block is split over."""
    return {n: tuple(a for e in spec for a in _axes(e)) for n, spec in specs.items()}


def zero_layout(cfg: ArchConfig, mesh, *, params: dict | None = None) -> dict:
    """ZeRO-1 on ``mesh``: the AdamW moments ``opt_shardings`` lays out,
    as ``train.adamw_init``'s ``zero``: name -> (dim, axes, parts) for
    every moment that splits a dim its parameter's train block holds
    whole, over ``axes`` into ``parts`` blocks. A rank's moments are then
    its ``opt_shardings`` blocks: their bytes are ``resident_bytes["opt"]``."""
    multi_pod = "pod" in mesh.shape
    params = abstract_params(cfg) if params is None else params
    base = param_shardings(cfg, mesh, multi_pod=multi_pod, kind="train", params=params)
    moments = opt_shardings(cfg, mesh, multi_pod=multi_pod, params=params)
    out = {}
    for name, spec in moments.items():
        for dim, (p_entry, m_entry) in enumerate(zip(base[name], spec, strict=True)):
            if p_entry is None and m_entry is not None:
                axes = _axes(m_entry)
                out[name] = (dim, axes, mesh.span(axes))
    return out


def _bdim(shape: InputShape, mesh, multi_pod: bool):
    dp = dp_axes(multi_pod)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    return _entry(dp) if shape.global_batch % dp_size == 0 else None


def batch_shardings(cfg: ArchConfig, shape: InputShape, mesh, *,
                    multi_pod: bool = False) -> dict[str, tuple]:
    bdim = _bdim(shape, mesh, multi_pod)
    return {k: (bdim,) + (None,) * (v.dim() - 1)
            for k, v in batch_specs(cfg, shape).items()}


def _cache_rule(cfg: ArchConfig, path: str, leaf, M: int, bdim) -> tuple:
    shp, nd = tuple(leaf.shape), leaf.dim()
    if path.endswith("pos"):
        return (bdim,)
    if cfg.family in ("dense", "moe", "vlm"):
        # k/v [L, B, C, kv, hd]: shard the cache length ("context parallel")
        return (None, bdim, "model" if shp[2] % M == 0 else None, None, None)
    if cfg.family == "audio":
        if path.startswith(("ck", "cv")):     # [L, B, enc, H, hd]
            return (None, bdim, None, None, None)
        return (None, bdim, "model" if shp[2] % M == 0 else None, None, None)
    if cfg.family == "hybrid":
        if path.startswith(("k", "v")):       # [G, B, C, kv, hd]
            return (None, bdim, "model" if shp[2] % M == 0 else None, None, None)
        if path.startswith("ssm"):            # [G, per, B, H, Pd, N]
            return (None, None, bdim, "model" if shp[3] % M == 0 else None, None, None)
        return (None, None, bdim) + (None,) * (nd - 3)
    if cfg.family == "ssm":
        # per-layer states [B, H, ...]: shard the state dim
        if nd >= 3 and shp[2] % M == 0:
            return (bdim, None, "model") + (None,) * (nd - 3)
        return (bdim,) + (None,) * (nd - 1)
    return ()


def cache_shardings(cfg: ArchConfig, shape: InputShape, mesh, *,
                    multi_pod: bool = False, cache=None):
    """Entries per cache tensor of a decode shape, nested as the cache
    (``cache``, default ``abstract_cache(cfg, shape)``)."""
    M = mesh.shape["model"]
    bdim = _bdim(shape, mesh, multi_pod)
    cache = abstract_cache(cfg, shape) if cache is None else cache

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(tree))
        return _cache_rule(cfg, path, tree, M, bdim)

    return walk(cache, "")


def shard_bytes(t: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of ``t`` held by each device under ``spec`` on ``mesh`` (the
    rules only shard dims they divide, so every shard is equal)."""
    n = t.numel()
    for entry in spec:
        for a in _axes(entry):
            n //= mesh.shape[a]
    return n * t.element_size()


def tree_shard_bytes(tree, specs, mesh) -> int:
    """``shard_bytes`` summed over a nested dict/list of tensors and the
    matching nest of entries."""
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(tree_shard_bytes(t, s, mesh) for t, s in zip(tree, specs, strict=True))
    return shard_bytes(tree, specs, mesh)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def batch_axes(global_batch: int, mesh, *, multi_pod: bool = False) -> tuple[str, ...]:
    """The axes a batch of ``global_batch`` rows is split over on ``mesh``
    (the ``_bdim`` rule): the data axes when they divide it, else none."""
    entry = _bdim(InputShape("b", 1, global_batch, "decode"), mesh, multi_pod)
    return _axes(entry)


def program_axes(cfg: ArchConfig, shape: InputShape, mesh, *,
                 multi_pod: bool = False) -> dict:
    """``collectives.use_mesh``'s keywords for a step of ``shape`` placed by
    these rules: the axes its batch rows and its decode cache length are
    split over."""
    C = max(cache_context(cfg, shape), 1)
    split = C % mesh.shape["model"] == 0
    return {"batch_axes": batch_axes(shape.global_batch, mesh, multi_pod=multi_pod),
            "cache_axes": ("model",) if split and mesh.shape["model"] > 1 else ()}


def local_block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` on a running ``mesh``, as
    a tensor of its own (the whole tensor can then be freed). A tuple entry
    splits its dim over its axes row-major, as a ``PartitionSpec`` does."""
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = mesh.span(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {axes}")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(axes) * size, size)
    return out.contiguous() if out is t else out.clone(memory_format=torch.contiguous_format)


def _blocks(tree, specs, mesh, device):
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v, s, mesh, device)
                          for v, s in zip(tree, specs, strict=True))
    return local_block(tree, specs, mesh).to(device)


# the families whose program (prefill, decode, the train step) runs sharded on a mesh
SHARDED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def place(model: torch.nn.Module | None, mesh, *, cfg: ArchConfig | None = None,
          kind: str = "decode", cache=None, batch=None, multi_pod: bool = False):
    """Put ``model`` (in place; may be None), ``cache`` and ``batch`` on
    ``mesh`` -> (model, cache, batch). On a (1, 1) mesh every entry keeps a tensor
    whole: all three move to the mesh's device. On a mesh of running ranks
    each parameter (by ``param_shardings`` of ``kind``), cache tensor
    (``cache_shardings``) and batch tensor (the batch rule) is replaced by
    this rank's block, the batch's rows split as ``batch_axes`` says; the
    tensors given must be whole. ``cfg`` is then required; its family must
    have a sharded program (``SHARDED_FAMILIES``). The cache may be any
    family's (the cache rules walk its nest). An abstract mesh of more
    than one device places nothing and raises."""
    if mesh.size == 1:
        dev = resolve_device(mesh.device)
        return (None if model is None else model.to(dev)), _to(cache, dev), _to(batch, dev)
    if not getattr(mesh, "running", False):
        raise ValueError(f"placing on a {mesh.sizes} mesh needs {mesh.size} running ranks "
                         "(distributed.launch.run_on_mesh); one card is the (1, 1) mesh")
    dev = resolve_device(mesh.device)
    if cfg is None or cfg.family not in SHARDED_FAMILIES:
        raise ValueError(f"the sharded program covers the {SHARDED_FAMILIES} families, "
                         f"not {getattr(cfg, 'family', None)!r}")
    if model is not None:
        params = dict(model.named_parameters())
        specs = param_shardings(cfg, mesh, multi_pod=multi_pod, kind=kind, params=params)
        with torch.no_grad():
            for name, p in params.items():
                p.data = local_block(p.data, specs[name], mesh).to(dev)
    if cache is not None:
        # the rules read the batch off ``pos`` and each tensor's dims off itself
        shape = InputShape("placed", 1, cache["pos"].shape[0], "decode")
        cache = _blocks(cache, cache_shardings(cfg, shape, mesh, multi_pod=multi_pod,
                                               cache=cache), mesh, dev)
    if batch is not None:
        rows = _entry(batch_axes(next(iter(batch.values())).shape[0], mesh,
                                 multi_pod=multi_pod) or (None,))
        batch = {k: local_block(v, (rows,) + (None,) * (v.dim() - 1), mesh).to(dev)
                 for k, v in batch.items()}
    return model, cache, batch


def residual_constraint(cfg: ArchConfig, shape: InputShape, mesh, *,
                        multi_pod: bool = False):
    """shard_h callback: sequence-parallel residual stream between layers
    (the reference's ``residual_constraint``). Called on a rank's residual
    ``h`` [B, S, d], it keeps the rank's block of S over "model" when
    ``shape.seq_len`` and S divide by the model axis, and ``h`` whole
    otherwise; the batch rows are already the rank's (``place``). The next
    layer, which needs the whole sequence, gathers it. Off a running mesh
    it is the identity."""
    from repro_torch.distributed import collectives
    M = mesh.shape["model"]
    split = shape.seq_len % M == 0

    def shard_h(h: torch.Tensor) -> torch.Tensor:
        if not split or h.dim() != 3 or h.shape[1] % M or collectives.current_mesh() is None:
            return h
        return collectives.block(h, "model", 1)

    return shard_h
