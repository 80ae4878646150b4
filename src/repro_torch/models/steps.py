"""Step-function factories (train / prefill / serve), abstract input specs
and cache geometry (port of ``repro/models/steps.py``).

The abstract specs are ``meta`` tensors (shape and dtype, no storage), the
counterpart of the reference's ``jax.ShapeDtypeStruct``s."""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import collectives as col
from repro_torch.models import api, decoder, whisper
from repro_torch.models.config import LONG_WINDOW, ArchConfig, InputShape
from repro_torch.train import adamw_update, chunked_lm_head_loss, clip_by_global_norm


# --------------------------------------------------------------- specs ----

def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    return seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len


def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, torch.Tensor]:
    """Meta tensors for the step's ``batch`` argument."""
    B, S = shape.global_batch, shape.seq_len
    act_dt = cfg.param_dtype
    if shape.kind == "decode":
        specs = {"tokens": _f((B, 1), torch.int32)}
    else:
        specs = {"tokens": _f((B, text_len(cfg, S)), torch.int32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = _f((B, cfg.n_patches, cfg.d_model), act_dt)
        if cfg.family == "audio":
            # decode reads the cross-attention KV from the cache instead
            specs["enc_states"] = _f((B, cfg.enc_len, cfg.d_model), act_dt)
    if shape.kind == "train":
        specs["labels"] = _f((B, S), torch.int32)
    return specs


def cache_specs(cfg: ArchConfig, shape: InputShape):
    """Abstract KV/state cache of a decode shape (context already consumed):
    ``api.init_cache``'s structure with meta tensors, built without
    allocating (the reference's ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if shape.kind != "decode":
        raise ValueError(f"cache_specs takes a decode shape, not {shape.kind!r}")
    with FakeTensorMode():
        cache = api.init_cache(cfg, shape.global_batch, cache_context(cfg, shape),
                               device="cpu")

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(meta(v) for v in tree)
        return _f(tuple(tree.shape), tree.dtype)

    return meta(cache)


def cache_context(cfg: ArchConfig, shape: InputShape) -> int:
    """Attention-cache length: full context, or ring window for long decode."""
    if cfg.family in ("ssm",):
        return 0                                    # pure recurrent state
    if shape.seq_len > 65_536:
        return LONG_WINDOW                          # ring-buffer sliding window
    return shape.seq_len


def uses_ring(cfg: ArchConfig, shape: InputShape) -> bool:
    return shape.kind == "decode" and cfg.family != "ssm" and shape.seq_len > 65_536


# --------------------------------------------------------------- steps ----

LB_COEFF = 0.01         # the MoE lb_loss's weight in the loss (the reference's default)


def split_axes(cfg: ArchConfig, mesh) -> dict[str, tuple[str, ...]]:
    """name -> the axes each parameter's train block is split over on
    ``mesh`` (``distributed.sharding``'s rules)."""
    return _split_axes(cfg, mesh.axis_names, mesh.sizes)


@functools.cache
def _split_axes(cfg: ArchConfig, axis_names: tuple, sizes: tuple) -> dict:
    # imported here: the rules read this module's specs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(sizes, axis_names, "meta")
    return shd.split_axes(shd.param_shardings(cfg, mesh, kind="train"))


def make_grad_step(cfg: ArchConfig, *, shard_h=None, microbatch: int | None = None):
    """(model, batch) -> (loss, metrics, grads): the train step up to its
    gradients, before clipping (``make_train_step``). On a running mesh
    each gradient is the rank's block of the whole batch's gradient: the
    rank's own is summed over the batch axes, except where the parameter's
    block is itself split over one of them (the 100B+ experts' FSDP
    blocks, whose sum the gather's backward made), and ``loss`` and the
    metrics are the global ones."""
    def loss_fn(model, batch):
        # labels are [B, S_total]; vision positions carry -100, so a VLM's
        # prefix is ignored by the loss
        h, aux = api.forward(model, batch, cfg, shard_h=shard_h, return_hidden=True,
                             sdpa=True)
        obj, metrics = chunked_lm_head_loss(model.lm_head, h, batch["labels"],
                                            lb_loss=aux["lb_loss"], lb_coeff=LB_COEFF,
                                            vocab=cfg.vocab)
        # on a mesh ``obj`` is the rank's term; the metrics hold the global loss
        value = obj if col.current_mesh() is None else (
            metrics["ce_loss"] + LB_COEFF * aux["lb_loss"])
        return obj, value, metrics

    def grads_of(model, names, params, batch):
        with torch.enable_grad():
            obj, value, metrics = loss_fn(model, batch)
            grads = torch.autograd.grad(obj, params)
        return value.detach(), {k: v.detach() for k, v in metrics.items()}, dict(
            zip(names, grads, strict=True))

    def grad_step(model, batch):
        names = [n for n, _ in model.named_parameters()]
        params = list(model.parameters())
        flags = [p.requires_grad for p in params]
        for p in params:
            p.requires_grad_(True)
        try:
            B = batch["tokens"].shape[0]
            if microbatch and microbatch > 1 and B % microbatch == 0:
                n = B // microbatch
                loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
                grads = {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in zip(names, params, strict=True)}
                for i in range(microbatch):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    mb_loss, metrics, mb_grads = grads_of(model, names, params, mb)
                    loss = loss + mb_loss
                    for k, g in grads.items():
                        g.add_(mb_grads[k].to(torch.float32))
                    del mb_grads
                loss = loss / microbatch
                grads = {k: g / microbatch for k, g in grads.items()}
            else:
                loss, metrics, grads = grads_of(model, names, params, batch)
        finally:
            for p, flag in zip(params, flags, strict=True):
                p.requires_grad_(flag)
        rows = col.batch_axes()
        if rows:
            split = split_axes(cfg, col.current_mesh())
            grads = {k: g if set(split[k]) & set(rows) else col.psum(g, rows)
                     for k, g in grads.items()}
        return loss, metrics, grads

    return grad_step


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, shard_h=None,
                    microbatch: int | None = None):
    """(model, opt_state, batch) -> (model, opt_state, metrics).

    The loss is ``chunked_lm_head_loss`` over ``api.forward(...,
    return_hidden=True)`` with the MoE ``lb_loss`` folded in; attention is
    the reference's ``use_flash=False`` computation (``sdpa=True``), which
    the reference trains through on every backend. With ``cfg.remat`` each
    layer's activations are recomputed in the backward (``models.remat``).
    Every parameter is differentiated, clipped to global norm 1.0 and
    AdamW-decayed, as the reference does for every leaf: the step turns
    grad on for the model's parameters while it runs and restores their
    flags after. ``microbatch`` = number of gradient-accumulation chunks
    along the (rank's) batch (f32 grads summed in chunk order, divided at
    the end; the metrics are the last chunk's), so only one chunk's
    activations are live at a time. The model is updated in place.

    On a running mesh (inside ``collectives.use_mesh`` with
    ``sharding.program_axes``) it is the sharded program over the rank's
    blocks, as the reference's dry run compiles it: a model placed by
    ``sharding.place(kind="train")``, ZeRO-1 moments
    (``adamw_init(model, zero=sharding.zero_layout(...))``), the rank's
    batch rows and ``shard_h = sharding.residual_constraint(...)``. It
    computes the one-rank step's function: the gradients are summed over
    the batch axes once (after the microbatches), the norm is the whole
    gradient's (``clip_by_global_norm(split=)``), and each rank updates its
    moments' block of every parameter, then gathers it. No gradient needs a
    sum over "model" for ``shard_h``: each layer gathers the sequence block
    before any parameter touches it, so norms and biases act on the whole
    sequence on every rank, and the collectives' transposes make the rest. With microbatches,
    microbatch i is every data rank's i-th chunk of its rows, normalised by
    its own global count: the one-rank step's when each chunk holds as many
    valid labels as the one-rank microbatch it stands for."""
    grad_step = make_grad_step(cfg, shard_h=shard_h, microbatch=microbatch)

    def train_step(model, opt_state, batch):
        loss, metrics, grads = grad_step(model, batch)
        mesh = col.current_mesh()
        split = None if mesh is None else split_axes(cfg, mesh)
        grads, gnorm = clip_by_global_norm(grads, 1.0, split=split)
        model, opt_state = adamw_update(model, grads, opt_state, lr=lr)
        return model, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg: ArchConfig, *, shard_h=None):
    """(model, batch) -> (last-token logits, populated cache or aux): the
    decoder families collect their KV cache, whisper prefills its
    cross-attention cache, and the ssm and hybrid families run the forward
    only and return its aux, as the reference does. A rank holding a vocab
    block of the ``lm_head`` keeps its logits split until the last position
    is taken, and gathers that position alone."""

    def prefill_step(params, batch):
        if cfg.family in ("dense", "moe", "vlm"):
            logits, _, out = decoder.forward(params, batch, cfg, shard_h=shard_h,
                                             collect_cache=True, vocab_block=True)
        else:
            logits, out = api.forward(params, batch, cfg, shard_h=shard_h, vocab_block=True)
            if cfg.family == "audio":
                out = whisper.prefill_cache(params, batch, cfg, batch["tokens"].shape[1])
        last = logits[:, -1]
        if last.shape[-1] != cfg.vocab:
            last = col.gather(last, "model", -1)
        return last, out

    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    """(model, batch, cache) -> (logits [B, 1, V], new_cache)."""
    ring = uses_ring(cfg, shape)
    dec_cfg = cfg.replace(window=LONG_WINDOW) if ring else cfg

    def serve_step(params, batch, cache):
        return api.decode_step(params, batch, cache, dec_cfg, ring=ring)

    return serve_step


def make_step(cfg: ArchConfig, shape: InputShape, **kw):
    if shape.kind == "train":
        return make_train_step(cfg, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, **kw)
    return make_serve_step(cfg, shape)
