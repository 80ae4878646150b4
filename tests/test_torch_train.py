"""Port's LM training path (``data.tokens.synthetic_lm_batches``,
``train.loss``, ``models.steps.make_train_step`` and its specs, the
``sdpa`` attention route, ``launch/train.py``) vs the JAX package's, on the
CPU, with the reference's weights carried by ``load_jax_params``.

Tolerances (errors relative to max(1, max |reference|) unless said):
- ``synthetic_lm_batches``, the abstract specs' shapes and dtypes: exact;
- ``lm_loss`` / ``chunked_lm_head_loss``: value and input gradients 1e-5;
- one train step per family (the counterpart of
  ``tests/test_archs.py::test_forward_and_train_step``), with and without
  microbatches: loss 1e-5, ``grad_norm`` 1e-4, the gradients (AdamW's first
  moment m = 0.1 g after one step) 1e-5, and every parameter after the
  step 1e-4 absolute. AdamW's first step moves an element by
  lr * g / (|g| + eps) with eps = 1e-8: where the reference's gradient
  lies within 100 eps of zero, f32 rounding of the gradient (summed in
  another order) decides a move of up to lr, so those elements are held
  within 2 lr; the gradient itself is held above;
- the set of parameters that receive a gradient equals the reference's.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.train import adamw_init as jadamw_init  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro_torch import nn as rnn  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import api, steps  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.train import adamw_init, chunked_lm_head_loss, lm_loss  # noqa: E402

TOL, GN_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
LR, EPS = 3e-4, 1e-8
FAMILIES = {"dense": "llama3.2-1b", "moe": "granite-moe-3b-a800m",
            "vlm": "llava-next-mistral-7b", "audio": "whisper-small",
            "ssm": "xlstm-125m", "hybrid": "zamba2-2.7b"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The smoke configs are small: one intra-op thread, so that parallel
    test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64) if isinstance(got, torch.Tensor) else got
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("vocab,seq_len,batch,seed", [(512, 32, 2, 0), (128256, 64, 3, 7)])
def test_synthetic_lm_batches_bit_for_bit(vocab, seq_len, batch, seed):
    ours = synthetic_lm_batches(vocab=vocab, seq_len=seq_len, batch=batch, seed=seed)
    ref = jtokens.synthetic_lm_batches(vocab=vocab, seq_len=seq_len, batch=batch, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------------ loss --

def _labels(rng, B, S, V):
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    y[rng.random((B, S)) < 0.2] = -100
    return y


@pytest.mark.parametrize("with_mask,lb", [(False, None), (True, 0.7)])
def test_lm_loss_value_and_gradient(with_mask, lb):
    rng = np.random.default_rng(1)
    B, S, V = 2, 12, 40
    logits = rng.standard_normal((B, S, V)).astype(np.float32) * 3
    y = _labels(rng, B, S, V)
    mask = rng.random((B, S)) < 0.7 if with_mask else None

    def jf(lg):
        return jloss.lm_loss(lg, jnp.asarray(y), mask=None if mask is None else jnp.asarray(mask),
                             lb_loss=None if lb is None else jnp.float32(lb))

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tl_in = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = lm_loss(tl_in, torch.from_numpy(y),
                     mask=None if mask is None else torch.from_numpy(mask),
                     lb_loss=None if lb is None else torch.tensor(lb))
    (tg,) = torch.autograd.grad(tl, tl_in)
    assert rel_err(jl, tl) < TOL and rel_err(jm["ce_loss"], tm["ce_loss"]) < TOL
    assert int(jm["n_tokens"]) == int(tm["n_tokens"])
    assert rel_err(jg, tg) < TOL


@pytest.mark.parametrize("S,chunk,lb", [(64, 16, None), (64, 16, 0.5), (16, 16, None),
                                        (40, 16, 0.5)])
def test_chunked_lm_head_loss_value_and_gradients(S, chunk, lb):
    """The chunked path (S a multiple of chunk, over it) and both
    fall-throughs to ``lm_loss`` (S <= chunk, S % chunk), with -100 labels;
    gradients with respect to h and to the head's weight."""
    rng = np.random.default_rng(S + chunk)
    B, d, V = 2, 24, 56
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / np.sqrt(d)).astype(np.float32)
    y = _labels(rng, B, S, V)

    def jf(hh, ww):
        return jloss.chunked_lm_head_loss({"w": ww}, hh, jnp.asarray(y), chunk=chunk,
                                          lb_loss=None if lb is None else jnp.float32(lb))

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    head = rnn.Linear(d, V)
    head.w.data.copy_(torch.from_numpy(w))
    head.w.requires_grad_(True)
    th = torch.from_numpy(h).requires_grad_(True)
    tl, tm = chunked_lm_head_loss(head, th, torch.from_numpy(y), chunk=chunk,
                                  lb_loss=None if lb is None else torch.tensor(lb))
    tgh, tgw = torch.autograd.grad(tl, (th, head.w))
    assert rel_err(jl, tl) < TOL and rel_err(jm["ce_loss"], tm["ce_loss"]) < TOL
    assert int(jm["n_tokens"]) == int(tm["n_tokens"])
    assert rel_err(jgh, tgh) < TOL and rel_err(jgw, tgw) < TOL


# ------------------------------------------------------------ train step --

def _batch(jcfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    jb, tb = {}, {}
    for k, spec in jsteps.batch_specs(jcfg, jsteps.InputShape("t", S, B, "train")).items():
        if spec.dtype == jnp.int32:
            a = rng.integers(0, jcfg.vocab, spec.shape).astype(np.int32)
        else:
            a = (rng.standard_normal(spec.shape) * 0.1).astype(np.float32)
        if k == "labels" and jcfg.family == "vlm":
            a[:, :jcfg.n_patches] = -100           # the vision prefix is ignored
        jb[k], tb[k] = jnp.asarray(a), torch.from_numpy(a)
    return jb, tb


def _carried(cfg_t, tree):
    return load_jax_params(api.init_model(1, cfg_t, device="cpu"), jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family, microbatch):
    name = FAMILIES[family]
    jcfg, tcfg = JARCHS[name].smoke(), ARCHS[name].smoke()
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    model = _carried(tcfg, jp)
    jb, tb = _batch(jcfg)
    jp2, jopt, jm = jsteps.make_train_step(jcfg, microbatch=microbatch)(jp, jadamw_init(jp), jb)
    model, opt, tm = steps.make_train_step(tcfg, microbatch=microbatch)(
        model, adamw_init(model), tb)

    assert np.isfinite(float(tm["loss"])) and float(tm["grad_norm"]) > 0
    assert rel_err(jm["loss"], tm["loss"]) < TOL
    assert rel_err(jm["ce_loss"], tm["ce_loss"]) < TOL
    assert int(jm["n_tokens"]) == int(tm["n_tokens"])
    assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) \
        / max(1.0, float(jm["grad_norm"])) < GN_TOL
    if family == "moe":
        assert float(japi.forward(jp, jb, jcfg)[1]["lb_loss"]) > 0

    ref_m = dict(_carried(tcfg, jopt["m"]).named_parameters())
    ref_p = dict(_carried(tcfg, jp2).named_parameters())
    moved_ref, moved = set(), set()
    for n, p in model.named_parameters():
        m = opt["m"][n]
        assert rel_err(ref_m[n].detach().numpy(), m) < TOL, n
        if bool((ref_m[n] != 0).any()):
            moved_ref.add(n)
        if bool((m != 0).any()):
            moved.add(n)
        g_ref = ref_m[n].detach() / 0.1
        err = (ref_p[n].detach() - p.detach()).abs()
        settled = g_ref.abs() >= 100 * EPS
        assert float(torch.where(settled, err, 0.0).max()) < PARAM_TOL, n
        assert float(err.max()) < 2 * LR, n
    assert moved == moved_ref and moved


def test_train_step_differentiates_every_parameter_and_restores_flags():
    """Parameters are built without grad (serving); the step differentiates
    every one, changes every one, and leaves the flags as it found them."""
    cfg = ARCHS["zamba2-2.7b"].smoke()
    model = api.init_model(0, cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, tb = _batch(JARCHS["zamba2-2.7b"].smoke(), seed=3)
    model, opt, _ = steps.make_train_step(cfg)(model, adamw_init(model), tb)
    assert not any(p.requires_grad for p in model.parameters())
    for n, p in model.named_parameters():
        assert bool((opt["m"][n] != 0).any()), n
        assert not torch.equal(before[n], p), n
    for name in ("a_log", "dt_bias", "d_skip"):
        assert any(n.endswith(name) for n in before)


def test_train_attention_takes_the_reference_path(monkeypatch):
    """With ``sdpa=True`` prefill computes ``_sdpa`` whatever ``use_flash``
    says, and never reaches the kernels' route."""
    cfg = ARCHS["llama3.2-1b"].smoke().replace(use_flash=True)
    model = api.init_model(0, cfg, device="cpu")
    _, tb = _batch(JARCHS["llama3.2-1b"].smoke())
    with torch.no_grad():
        want, _ = api.forward(model, tb, cfg.replace(use_flash=False))

    def refuse(*a, **k):
        raise AssertionError("the train step reached kernels.ops.flash_attention")

    monkeypatch.setattr(kops, "flash_attention", refuse)
    with torch.no_grad():
        got, _ = api.forward(model, tb, cfg, sdpa=True)
    assert torch.equal(want, got)
    steps.make_train_step(cfg)(model, adamw_init(model), tb)
    with pytest.raises(AssertionError, match="kernels.ops"):
        with torch.no_grad():
            api.forward(model, tb, cfg)


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """The kernels have no backward: with grad enabled, an input that
    requires grad raises before anything else is checked; without grad the
    wrapper goes on to its device check."""
    q = torch.zeros(1, 1 if kernel == "decode" else 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)

    def call():
        if kernel == "flash":
            return fa.flash_attention(q, k, v)
        return da.decode_attention(q, k, v, torch.ones(1, 8, dtype=torch.bool))

    q.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors only"):
        call()
    q.requires_grad_(False)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call()


# ----------------------------------------------------------------- specs --

def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, f"{path}/{key}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_flat(val, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_and_cache_specs_match_reference(name):
    shapes = list(INPUT_SHAPES.values()) + [InputShape("smoke_dec", 32, 2, "decode")]
    jshapes = list(J_SHAPES.values()) + [jsteps.InputShape("smoke_dec", 32, 2, "decode")]
    for cfgs in ((ARCHS[name], JARCHS[name]), (ARCHS[name].smoke(), JARCHS[name].smoke())):
        for shape, jshape in zip(shapes, jshapes, strict=True):
            got = steps.batch_specs(cfgs[0], shape)
            assert all(t.device.type == "meta" for t in got.values())
            assert _flat(got) == _flat(jsteps.batch_specs(cfgs[1], jshape))
            if shape.kind == "decode":
                assert _flat(steps.cache_specs(cfgs[0], shape)) == \
                    _flat(jsteps.cache_specs(cfgs[1], jshape))
    with pytest.raises(ValueError, match="decode"):
        steps.cache_specs(ARCHS[name], INPUT_SHAPES["train_4k"])


def test_make_step_dispatches_on_kind():
    cfg = ARCHS["llama3.2-1b"].smoke()
    for kind in ("train", "prefill", "decode"):
        fn = steps.make_step(cfg, InputShape("s", 32, 2, kind))
        assert fn.__name__ == {"train": "train_step", "prefill": "prefill_step",
                               "decode": "serve_step"}[kind]


# -------------------------------------------------------------- launcher --

def test_train_launcher_on_cpu(capsys):
    out = train_launch.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                             "--seq-len", "32", "--microbatch", "2"])
    text = capsys.readouterr().out
    assert "llama3.2-1b: " in text and "step    1 loss=" in text and text.endswith("done\n")
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in out["history"])
    assert out["peak_gib"] is None and out["tokens_per_s"] > 0
    snap = copy.deepcopy(out["model"])
    assert not any(p.requires_grad for p in snap.parameters())
