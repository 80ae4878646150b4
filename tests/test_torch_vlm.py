"""Port's vlm family (llava-next-mistral-7b: the decoder with projected
vision embeddings prepended) vs the JAX reference on the CPU, at smoke size
with the reference's weights carried across through ``models/convert.py``,
and the live stage server that draws the vision embeddings.

Tolerances: forward and chained decode logits within 1e-4 on the plain
path and 5e-3 with the kernels' plain versions against the Pallas kernels
in interpret mode. ``jax.random`` cannot be reproduced in torch, so both
packages get one set of NumPy vision embeddings.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_families import carry  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models import decoder, steps  # noqa: E402
from repro_torch.models.convert import cache_from_numpy  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

NAME = "llava-next-mistral-7b"
PLAIN_TOL, KERNEL_TOL = 1e-4, 5e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def err(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float32) - b.detach().float().numpy()).max())


def pair(use_flash=False):
    jcfg = JARCHS[NAME].smoke().replace(use_flash=use_flash)
    tcfg = ARCHS[NAME].smoke().replace(use_flash=use_flash)
    jp = jmodels.init_model(KEY, jcfg)
    return jcfg, tcfg, jp, carry(models.init_model(1, tcfg, device="cpu"), jp)


def vision_embeds(B, cfg, seed=0):
    return (np.random.default_rng(seed + 100).standard_normal((B, cfg.n_patches, cfg.d_model))
            * 0.02).astype(np.float32)


def batches(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    vis = vision_embeds(B, cfg, seed)
    return ({"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis)},
            {"tokens": torch.from_numpy(toks), "vision_embeds": torch.from_numpy(vis)})


def test_config_matches_reference():
    for j, t in ((JARCHS[NAME], ARCHS[NAME]), (JARCHS[NAME].smoke(), ARCHS[NAME].smoke())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    assert models._mod(ARCHS[NAME]) is decoder
    assert steps.text_len(ARCHS[NAME], 608) == 32


def test_init_model_has_the_projector():
    cfg = ARCHS[NAME].smoke()
    model = models.init_model(0, cfg, device="cpu")
    assert model.vis_proj.w.shape == (cfg.d_model, cfg.d_model)
    assert not hasattr(models.init_model(0, ARCHS["llama3.2-1b"].smoke(), device="cpu"),
                       "vis_proj")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jmodels.init_model(KEY, JARCHS[NAME]
                                                                       .smoke())))


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(use_flash):
    """The P patch positions come first: logits [B, P + S, V]."""
    jcfg, tcfg, jp, model = pair(use_flash)
    jb, tb = batches(tcfg, 2, 12)
    jl, _ = jmodels.forward(jp, jb, jcfg)
    with torch.no_grad():
        tl, aux = models.forward(model, tb, tcfg)
    assert tl.shape == (2, tcfg.n_patches + 12, tcfg.vocab) and float(aux["lb_loss"]) == 0.0
    assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_and_decode_steps_match_reference(use_flash):
    """The prefill step's cache (patches and text, pos = P + S), copied into
    a longer cache, then four chained decode steps."""
    jcfg, tcfg, jp, model = pair(use_flash)
    jb, tb = batches(tcfg, 2, 6, seed=1)
    S_total = tcfg.n_patches + 6
    jl, jpre = jsteps.make_prefill_step(jcfg)(jp, jb)
    with torch.no_grad():
        tl, tpre = steps.make_prefill_step(tcfg)(model, tb)
    tol = KERNEL_TOL if use_flash else PLAIN_TOL
    assert err(jl, tl) < tol and tpre["pos"].tolist() == [S_total, S_total]
    assert tpre["k"].shape == (tcfg.n_layers, 2, S_total, tcfg.n_kv, tcfg.head_dim)
    jcache = jmodels.init_cache(jcfg, 2, S_total + 4)
    jcache = {"k": jcache["k"].at[:, :, :S_total].set(jpre["k"]),
              "v": jcache["v"].at[:, :, :S_total].set(jpre["v"]), "pos": jpre["pos"]}
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    nxt = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 4)).astype(np.int32)
    for i in range(4):
        jl, jcache = jmodels.decode_step(jp, {"tokens": jnp.asarray(nxt[:, i:i + 1])}, jcache,
                                         jcfg)
        with torch.no_grad():
            tl, tcache = models.decode_step(model, {"tokens": torch.from_numpy(nxt[:, i:i + 1])},
                                            tcache, tcfg)
        assert err(jl, tl) < tol, i


def test_decode_equals_teacher_forced_forward():
    """The port against itself: prefill the patches and a text prefix, then
    decode the rest of the text; the logits equal the full forward's."""
    _, tcfg, _, model = pair()
    _, tb = batches(tcfg, 2, 9, seed=3)
    P = tcfg.n_patches
    with torch.no_grad():
        full, _ = models.forward(model, tb, tcfg)
        _, pre = steps.make_prefill_step(tcfg)(
            model, {"tokens": tb["tokens"][:, :5], "vision_embeds": tb["vision_embeds"]})
    cache = models.init_cache(tcfg, 2, P + 9, device="cpu")
    cache["k"][:, :, :P + 5], cache["v"][:, :, :P + 5] = pre["k"], pre["v"]
    cache["pos"] = pre["pos"]
    for i in range(5, 9):
        with torch.no_grad():
            lg, cache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                           cache, tcfg)
        assert torch.allclose(lg[:, 0], full[:, P + i], atol=PLAIN_TOL), i


# ------------------------------------------------------------ live stage --

def test_stage_server_draws_vision_embeds():
    """f32 normal with std 0.02 from a generator seeded 0, the same on
    every batch, [B, n_patches, d]; other families get none."""
    cfg = ARCHS[NAME].smoke()
    server = engine.StageServer("s3", [cfg], device="cpu")
    toks = np.zeros((3, 4), dtype=np.int32)
    a, b = server._make_batch(toks, cfg), server._make_batch(toks, cfg)
    assert a["vision_embeds"].shape == (3, cfg.n_patches, cfg.d_model)
    assert a["vision_embeds"].dtype == torch.float32
    assert torch.equal(a["vision_embeds"], b["vision_embeds"])
    assert abs(float(a["vision_embeds"].std()) - 0.02) < 5e-3
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(a["vision_embeds"], torch.randn((3, cfg.n_patches, cfg.d_model),
                                                       generator=gen) * 0.02)
    assert "vision_embeds" not in server._make_batch(toks, ARCHS["granite-3-8b"].smoke())
    assert "enc_states" not in a


def test_live_stage_executes_like_the_reference(monkeypatch):
    """paper-4stage's stage 3 (granite-3-8b, llava) as live smoke stage
    servers with carried weights and one set of vision embeddings: each
    variant's output tokens [B, P + S] equal the reference's."""
    names = [ARCHS["granite-3-8b"].smoke(), ARCHS[NAME].smoke()]
    jserver = jengine.StageServer("s3", [JARCHS[c.name].smoke() for c in names])
    tserver = engine.StageServer("s3", names, device="cpu")
    for model, jp in zip(tserver.params, jserver.params, strict=True):
        carry(model, jp)

    def shared(jax_side, original):
        def make_batch(self, tokens, cfg):
            batch = original(self, tokens, cfg)
            if cfg.family == "vlm":
                e = vision_embeds(tokens.shape[0], cfg, seed=tokens.shape[0])
                batch["vision_embeds"] = jnp.asarray(e) if jax_side else torch.from_numpy(e)
            return batch
        return make_batch

    monkeypatch.setattr(jengine.StageServer, "_make_batch",
                        shared(True, jengine.StageServer._make_batch))
    monkeypatch.setattr(engine.StageServer, "_make_batch",
                        shared(False, engine.StageServer._make_batch))
    for z, B in ((0, 3), (1, 3), (1, 1)):
        toks = np.random.default_rng(B + z).integers(0, 50_000, (B, 32)).astype(np.int32)
        want = np.asarray(jserver.execute(z, toks))
        got = tserver.execute(z, toks)
        width = 32 + (names[z].n_patches if names[z].family == "vlm" else 0)
        assert got.dtype == np.int32 and got.shape == want.shape == (B, width)
        assert np.array_equal(got, want), (z, B)
