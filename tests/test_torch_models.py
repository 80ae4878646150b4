"""Port models vs the JAX reference on the CPU: configs, forward, prefill
step and chained decode steps of the llama3.2-1b and starcoder2-3b smoke
configs, with the JAX weights carried across.

Tolerances: logits within 1e-4 on the plain path (f32, two layers, same
arithmetic in another summation order), and within 5e-3 on the kernel path
(JAX's Pallas kernels in interpret mode against the port's plain kernel
versions; the same bound as
``tests/test_kernels.py::test_flash_matches_model_attention_path``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import api, decoder, steps  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, LONG_WINDOW, InputShape  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, load_jax_params  # noqa: E402

NAMES = ["llama3.2-1b", "starcoder2-3b"]
PLAIN_TOL, KERNEL_TOL = 1e-4, 5e-3


def pair(name, use_flash=False):
    jcfg = JARCHS[name].smoke().replace(use_flash=use_flash)
    tcfg = ARCHS[name].smoke().replace(use_flash=use_flash)
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(api.init_model(1, tcfg, device="cpu"),
                            jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, model


def tokens(B, S, vocab, seed=0):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    for j, t in ((JARCHS[name], ARCHS[name]), (JARCHS[name].smoke(), ARCHS[name].smoke())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
        assert j.head_dim == t.head_dim
    assert ARCHS[name].param_dtype == torch.float32
    assert ARCHS[name].replace(dtype="bfloat16").param_dtype == torch.bfloat16


def test_input_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name in NAMES:
        for shape in INPUT_SHAPES.values():
            jc, tc = JARCHS[name], ARCHS[name]
            assert steps.cache_context(tc, shape) == jsteps.cache_context(jc, shape)
            assert steps.uses_ring(tc, shape) == jsteps.uses_ring(jc, shape)
            assert steps.text_len(tc, shape.seq_len) == jsteps.text_len(jc, shape.seq_len)


@pytest.mark.parametrize("use_flash,tol", [(False, PLAIN_TOL), (True, KERNEL_TOL)])
@pytest.mark.parametrize("name", NAMES)
def test_forward(name, use_flash, tol):
    jcfg, tcfg, jp, model = pair(name, use_flash)
    jb, tb = tokens(2, 32, tcfg.vocab)
    jl, _ = japi.forward(jp, jb, jcfg)
    with torch.inference_mode():
        tl, aux = api.forward(model, tb, tcfg)
        tlast, _ = api.forward(model, tb, tcfg, last_only=True)
    assert tuple(tl.shape) == jl.shape
    assert err(jl, tl) < tol
    assert torch.allclose(tlast[:, 0], tl[:, -1], atol=1e-5)
    assert set(aux) == {"lb_loss", "dropped_frac"}


@pytest.mark.parametrize("name", NAMES)
def test_prefill_step(name):
    jcfg, tcfg, jp, model = pair(name)
    jb, tb = tokens(2, 16, tcfg.vocab, seed=1)
    jl, jc = jsteps.make_prefill_step(jcfg)(jp, jb)
    with torch.inference_mode():
        tl, tc = steps.make_prefill_step(tcfg)(model, tb)
    assert err(jl, tl) < PLAIN_TOL
    assert err(jc["k"], tc["k"]) < PLAIN_TOL and err(jc["v"], tc["v"]) < PLAIN_TOL
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("use_flash,tol", [(False, PLAIN_TOL), (True, KERNEL_TOL)])
@pytest.mark.parametrize("name", NAMES)
def test_three_chained_decode_steps(name, use_flash, tol):
    jcfg, tcfg, jp, model = pair(name, use_flash)
    shape = InputShape("decode_16", 16, 2, "decode")
    jstep = jsteps.make_serve_step(jcfg, shape)
    tstep = steps.make_serve_step(tcfg, shape)
    jcache = japi.init_cache(jcfg, 2, 16)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    rng = np.random.default_rng(2)
    for _ in range(3):
        t = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jstep(jp, {"tokens": jnp.asarray(t)}, jcache)
        with torch.inference_mode():
            tl, tcache = tstep(model, {"tokens": torch.from_numpy(t)}, tcache)
        assert err(jl, tl) < tol
    assert err(jcache["k"], tcache["k"]) < tol and err(jcache["v"], tcache["v"]) < tol
    assert np.array_equal(np.asarray(jcache["pos"]), tcache["pos"].numpy())


def test_decode_after_prefill_matches_forward():
    """Prefill a prefix, then decode the rest: the decode logits equal the
    full forward's logits at those positions (the port against itself)."""
    _, tcfg, _, model = pair("llama3.2-1b")
    _, tb = tokens(2, 12, tcfg.vocab, seed=3)
    with torch.inference_mode():
        full, _ = api.forward(model, tb, tcfg)
        _, pre = steps.make_prefill_step(tcfg)(model, {"tokens": tb["tokens"][:, :8]})
        cache = decoder.init_cache(tcfg, 2, 16, device="cpu")
        cache["k"][:, :, :8] = pre["k"]
        cache["v"][:, :, :8] = pre["v"]
        cache["pos"] = pre["pos"]
        for i in range(8, 12):
            lg, cache = api.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]}, cache, tcfg)
            assert torch.allclose(lg[:, 0], full[:, i], atol=PLAIN_TOL)


def test_ring_serve_step_for_long_decode():
    tcfg = ARCHS["llama3.2-1b"].smoke()
    assert steps.uses_ring(tcfg, INPUT_SHAPES["long_500k"])
    assert steps.cache_context(tcfg, INPUT_SHAPES["long_500k"]) == LONG_WINDOW


FAMILY_ARCH = {"moe": "granite-moe-3b-a800m", "vlm": "llava-next-mistral-7b",
               "audio": "whisper-small", "hybrid": "zamba2-2.7b", "ssm": "xlstm-125m"}
FAMILY_MODULE = {"moe": "decoder", "vlm": "decoder", "audio": "whisper",
                 "hybrid": "zamba", "ssm": "xlstm_lm"}


@pytest.mark.parametrize("family", ["moe", "vlm", "audio", "hybrid", "ssm"])
def test_other_families_not_ported_yet(family):
    """Every family is ported now (the name is the test's history): each
    family's smoke config builds the module of its family, with the
    reference's parameter count (tests/test_torch_{moe,vlm,families,hybrid}.py
    hold them against it)."""
    cfg = ARCHS[FAMILY_ARCH[family]].smoke()
    assert cfg.family == family
    model = api.init_model(0, cfg, device="cpu")
    assert type(model).__module__ == api._mod(cfg).__name__
    assert api._mod(cfg).__name__.rsplit(".", 1)[1] == FAMILY_MODULE[family]
    jn = sum(x.size for x in jax.tree.leaves(japi.init_model(
        jax.random.PRNGKey(0), JARCHS[FAMILY_ARCH[family]].smoke())))
    assert sum(p.numel() for p in model.parameters()) == jn


def test_decoder_refuses_moe_interleave_and_vlm():
    """The decoder takes the MoE interleave now (the name is the test's
    history): blocks of sub-layers, the last one MoE; and the VLM prefix
    (``vis_proj``; patches before the text)."""
    cfg = ARCHS["llama3.2-1b"].smoke()
    moe = cfg.replace(n_experts=4, top_k=1, moe_every=2)
    model = decoder.init_model(0, moe, device="cpu")
    assert len(model.layers) == 1
    assert hasattr(model.layers[0].sub0, "mlp") and hasattr(model.layers[0].sub1, "moe")
    _, tb = tokens(2, 6, cfg.vocab)
    with torch.no_grad():
        logits, aux, cache = decoder.forward(model, tb, moe, collect_cache=True)
    assert logits.shape == (2, 6, cfg.vocab) and cache["k"].shape[0] == moe.n_layers
    assert float(aux["lb_loss"]) > 0.0
    vlm = cfg.replace(family="vlm", n_patches=3)
    model = decoder.init_model(0, vlm, device="cpu")
    vis = torch.zeros(2, 3, cfg.d_model)
    with torch.no_grad():
        logits, _ = decoder.forward(model, {**tb, "vision_embeds": vis}, vlm)
    assert model.vis_proj.w.shape == (cfg.d_model, cfg.d_model)
    assert logits.shape == (2, 9, cfg.vocab)


def test_init_model_is_seeded_with_reference_distributions():
    cfg = ARCHS["llama3.2-1b"].smoke()
    a = api.init_model(0, cfg, device="cpu")
    b = api.init_model(0, cfg, device="cpu")
    c = api.init_model(1, cfg, device="cpu")
    assert torch.equal(a.lm_head.w, b.lm_head.w) and not torch.equal(a.lm_head.w, c.lm_head.w)
    assert abs(float(a.embed.e.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].mlp.wd.w.std()) - cfg.d_ff ** -0.5) < 5e-3
    assert torch.equal(a.ln_f.g, torch.ones(cfg.d_model))
    n = sum(p.numel() for p in a.parameters())
    jn = sum(x.size for x in jax.tree.leaves(japi.init_model(jax.random.PRNGKey(0),
                                                             JARCHS["llama3.2-1b"].smoke())))
    assert n == jn


def test_load_jax_params_rejects_mismatch():
    jcfg, tcfg, jp, model = pair("llama3.2-1b")
    tree = jax.tree.map(np.asarray, jp)
    tree["ln_f"]["g"] = tree["ln_f"]["g"][:-1]
    with pytest.raises(ValueError, match="ln_f.g"):
        load_jax_params(model, tree)
    tree = jax.tree.map(np.asarray, jp)
    del tree["lm_head"]
    with pytest.raises(KeyError, match="lm_head.w"):
        load_jax_params(model, tree)


def test_bfloat16_weights_carry_across():
    jcfg = JARCHS["llama3.2-1b"].smoke().replace(dtype="bfloat16")
    tcfg = ARCHS["llama3.2-1b"].smoke().replace(dtype="bfloat16")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(api.init_model(0, tcfg, device="cpu"), jax.tree.map(np.asarray, jp))
    assert model.lm_head.w.dtype == torch.bfloat16
    want = np.asarray(jp["lm_head"]["w"].astype(jnp.float32))
    assert np.array_equal(model.lm_head.w.float().numpy(), want)
