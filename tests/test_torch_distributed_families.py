"""The port's sharded serving program for the audio (whisper-small), hybrid
(zamba2-2.7b), ssm (xlstm-125m) and vlm (llava-next-mistral-7b) families on
a ("data", "model") mesh of CPU ranks (gloo, spawned by
``distributed.launch.run_on_mesh``, one thread each) at smoke widths,
against the one-rank program and against the JAX package.

  * each family on (2, 2) and (2, 4), and on (1, 4) whisper with an odd
    vocab (511, as whisper-small's 51865: the embedding splits its width
    and the lm_head its rows), whisper with 2 heads (heads that do not
    divide the model axis, as 12 on 16: the attention stays whole) and the
    xLSTM with 2 heads (a head split over two ranks, and ``up``'s
    [xi | gate] split 2 + 2) and zamba2 with 2 heads (a Mamba2 head split
    over two ranks, its SSM state then whole by the rule, and the shared
    attention whole): ``forward`` with and without ``shard_h``,
    ``make_prefill_step``'s last position (the logits vocab-split until
    then) and what it returns beside it (the collected or cross-attention
    cache's blocks, or the aux), and 8 ``decode_step``s equal the one-rank
    run; the bytes each rank holds equal the rules'; the blocks rebuild
    the whole parameters. The xLSTM cases carry ``slstm_every=2`` so that
    an sLSTM layer is among the smoke config's two; on (2, 4) its
    ``d_model`` is 192, so that the sLSTM's feed-forward width (256)
    divides the model axis and splits;
  * each family's sharded forward (with ``shard_h``) and 8 decode steps on
    (2, 2) against the JAX package's on one device, with the reference's
    weights carried across (``models.convert``);
  * ``StageExecutor(mesh=)`` of each family on (1, 2) against the one-rank
    executor;
  * the dry run: zamba2's decode collective bytes on a fake 2 x 4 group
    against a closed form, and the xLSTM's and zamba2's prefill mesh count
    extrapolated in S equal to a count of the whole step.

Tolerance: f32, 1e-4 of max(1, max |reference|); bytes exactly. Every
launch of ranks is cut at 60 s (``run_on_mesh(timeout=)``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import parity  # noqa: E402
from repro_torch.distributed.launch import run_on_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

TOL = 1e-4
LIMIT_S = 60            # each launch of ranks
WHISPER, ZAMBA, XLSTM, LLAVA = ("whisper-small", "zamba2-2.7b", "xlstm-125m",
                                "llava-next-mistral-7b")
FAMILIES = [WHISPER, ZAMBA, XLSTM, LLAVA]
SLSTM = {"slstm_every": 2}
# (arch, config overrides, parity.decoder keywords) per mesh
ARCH_CASES = {(1, 4): [(WHISPER, {"vocab": 511}, {}),
                       (WHISPER, {"n_heads": 2, "n_kv": 2}, {}),
                       (XLSTM, {"n_heads": 2, **SLSTM}, {}),
                       (ZAMBA, {"n_heads": 2, "n_kv": 2}, {})],
              (2, 2): [(WHISPER, {}, {}), (ZAMBA, {}, {}), (XLSTM, SLSTM, {}), (LLAVA, {}, {})],
              (2, 4): [(WHISPER, {}, {}), (ZAMBA, {}, {}),
                       (XLSTM, {"d_model": 192, **SLSTM}, {}), (LLAVA, {}, {})]}
CASES = [(shape, i) for shape in ARCH_CASES for i in range(len(ARCH_CASES[shape]))]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@functools.cache
def mesh_run(shape):
    return run_on_mesh(parity.decoders, shape, device="cpu", args=(ARCH_CASES[shape],),
                       timeout=LIMIT_S)


def _case_id(case):
    shape, i = case
    arch, over, kw = ARCH_CASES[shape][i]
    return f"{'x'.join(map(str, shape))}-{arch}" + "".join(
        f"-{k}{v}" for k, v in {**over, **kw}.items())


def _cfg(shape, i):
    arch, over, _ = ARCH_CASES[shape][i]
    return ARCHS[arch].smoke().replace(**over)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_family_matches_one_rank(case):
    """forward (with and without shard_h), the prefill step's last position
    and cache (or aux), and 8 decode steps on the mesh equal the one-rank
    run."""
    shape, i = case
    res = mesh_run(shape)
    errs = res[0][i]["errs"]
    assert {"forward", "forward_shard_h", "prefill_last", "decode"} <= set(errs)
    assert ("prefill_cache" in errs) == (_cfg(shape, i).family in ("audio", "vlm"))
    assert max(errs.values()) <= TOL, errs
    assert all(r[i]["finite"] for r in res)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_family_place_holds_the_rules_block(case):
    """Every rank holds exactly its block of the parameters and of the
    decode cache: its bytes are the rules' bytes per device, fewer than the
    whole model's, and the blocks of all ranks rebuild every parameter."""
    shape, i = case
    for r in mesh_run(shape):
        got = r[i]
        assert got["param_bytes"] == got["param_bytes_rule"]
        assert got["cache_bytes"] == got["cache_bytes_rule"]
        assert got["blocks_err"] == 0.0
    whole = sum(p.numel() * p.element_size()
                for p in parity.shd.abstract_params(_cfg(shape, i)).values())
    assert mesh_run(shape)[0][i]["param_bytes"] < whole


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_family_prefill_keeps_logits_vocab_split(case):
    """The prefill's forward keeps the rank's vocab block of the logits
    (V / M wide where the lm_head is vocab-split: every case but the odd
    vocab, whose lm_head splits its rows and gives whole logits)."""
    shape, i = case
    cfg = _cfg(shape, i)
    M = shape[1]
    for r in mesh_run(shape):
        assert r[i]["prefill_logits_width"] == (cfg.vocab // M if cfg.vocab % M == 0
                                                else cfg.vocab)


# ------------------------------------------------- against the JAX package --

def _jax_run(arch: str, overrides: dict, tmp_path, B: int = 4, S: int = 8,
             steps: int = 8, context: int = 16):
    """The reference on one device: forward and ``steps`` decode steps of
    the smoke model from PRNGKey(0), its weights carried into the port's
    model and saved with the inputs -> (the save's path, the reference's
    forward and decode logits)."""
    jcfg = JARCHS[arch].smoke().replace(**overrides)
    tcfg = ARCHS[arch].smoke().replace(**overrides)
    jp = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(api.init_model(1, tcfg, device="cpu"),
                            jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)}
    if tcfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, tcfg.n_patches, tcfg.d_model)).astype(np.float32)
    if tcfg.family == "audio":
        batch["enc_states"] = rng.standard_normal(
            (B, tcfg.enc_len, tcfg.d_model)).astype(np.float32)
    fed = rng.integers(0, tcfg.vocab, (steps, B, 1)).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_fwd, _ = jmodels.forward(jp, jb, jcfg)
    cache = (jwhisper.prefill_cache(jp, jb, jcfg, context) if tcfg.family == "audio"
             else jmodels.init_cache(jcfg, B, context))
    want_dec = []
    for t in fed:
        logits, cache = jmodels.decode_step(jp, {"tokens": jnp.asarray(t)}, cache, jcfg)
        want_dec.append(np.asarray(logits))
    path = tmp_path / f"{arch}.pt"
    torch.save({"arch": arch, "overrides": overrides, "context": context,
                "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "fed": torch.from_numpy(fed)}, path)
    return str(path), np.asarray(want_fwd), np.stack(want_dec)


@pytest.mark.parametrize("arch,overrides", [(WHISPER, {}), (ZAMBA, {}), (XLSTM, SLSTM),
                                            (LLAVA, {})])
def test_sharded_family_matches_reference(arch, overrides, tmp_path):
    """The port's sharded forward with shard_h and 8 decode steps on (2, 2)
    against the JAX package's forward and decode on one device (the same
    function the reference's sharded program computes), with the
    reference's weights."""
    path, want_fwd, want_dec = _jax_run(arch, overrides, tmp_path)
    got = run_on_mesh(parity.carried, (2, 2), device="cpu", args=(path,),
                      timeout=LIMIT_S)[0]
    assert got["forward"].shape == want_fwd.shape
    assert rel(got["forward"], want_fwd) <= TOL
    assert got["decode"].shape == want_dec.shape
    assert rel(got["decode"], want_dec) <= TOL


# ------------------------------------------------------- StageExecutor ----

@functools.cache
def stage_run():
    cases = [(arch, {}, {"smoke": True, "steps": 4}) for arch in FAMILIES]
    return run_on_mesh(parity.stages, (1, 2), device="cpu", args=(cases,), timeout=LIMIT_S)


@pytest.mark.parametrize("i", range(len(FAMILIES)), ids=FAMILIES)
def test_family_stage_executor_on_a_mesh_matches_one_rank(i):
    """StageExecutor(mesh=) on two ranks: its serving step (whisper's cross
    cache filled) and a prefill with shard_h equal the one-rank executor's;
    the mesh enters the cache key and the calibration label; the
    attention families decode over a cache split over "model", merged by
    lse."""
    ranks = [r[i] for r in stage_run()]
    assert max(ranks[0]["errs"].values()) <= TOL, ranks[0]["errs"]
    attention = FAMILIES[i] != XLSTM
    for r in ranks:
        assert r["finite"] and r["backend"] == "gloo" and r["device_class"] == "cpu2"
        assert r["cache_key_mesh"] == [("data", 1), ("model", 2)]
        assert r["step_ms"] == ranks[0]["step_ms"] > 0          # the slowest rank's
        assert r["cache_axes"] == (["model"] if attention else [])
        assert (r["lse_calls"] > 0) == attention


# ------------------------------------------------------------- dry run ----

def _zamba_decode_closed_form(M: int, dp: int) -> float:
    """Bytes per device zamba2's smoke decode_32k step moves on a (dp, M)
    mesh, from its all-reduces (a ring all_reduce of n bytes over g ranks
    moves 2(g - 1)/g n), bf16, every width divides M: the embedding's sum;
    per group the shared block's q, k, v gathers, lse max, (out, weight)
    sum, wo and MLP sums, then its mamba layer's x-channel gather, norm
    sum of squares (f32) and out_proj sum; the logits' gather."""
    cfg = dryrun.arch_config(ZAMBA, smoke=True)
    shp = dryrun.INPUT_SHAPES["decode_32k"]
    B, d, V, es = shp.global_batch // dp, cfg.d_model, cfg.vocab, 2
    H, Hkv, D, d_inner = cfg.n_heads, cfg.n_kv, cfg.head_dim, 2 * cfg.d_model
    G = cfg.n_layers // cfg.attn_every
    shared = B * (H + 2 * Hkv) * D * es + B * H * 4 + B * (H * D + H) * 4 + 2 * B * d * es
    mamba = B * d_inner * es + B * 4 + B * d * es
    n = B * d * es + G * (shared + cfg.attn_every * mamba) + B * V * es
    return 2 * (M - 1) / M * n


def test_dryrun_counts_zamba_decode_collectives_on_fake_8_rank_group():
    rec = dryrun.count(ZAMBA, "decode_32k", smoke=True, mesh="2x4")
    assert rec["status"] == "OK" and rec["counted_by"] == {"direct": True}
    groups = rec["roofline"]["collective"]["groups"]
    assert set(groups) == {"model"}
    assert groups["model"]["bytes_per_device"] == _zamba_decode_closed_form(4, 2)
    assert rec["attention_calls"]["decode_attention"] == 2        # one a group
    full = dryrun.count(ZAMBA, "decode_32k", smoke=True)
    assert rec["resident_bytes"]["params"] < full["resident_bytes"]["params"]
    assert rec["resident_bytes"]["cache"] < full["resident_bytes"]["cache"]


@pytest.mark.parametrize("arch,overrides,seqs,S", [
    (XLSTM, SLSTM, (16, 24, 32), 40),        # one mLSTM (parallel form) and one sLSTM layer
    (ZAMBA, {}, (64, 128, 192), 256),        # the shared attention's parabola
])
def test_mesh_count_extrapolated_in_s_equals_the_whole_step(arch, overrides, seqs, S):
    """A recurrent family's prefill mesh count at full depth, from counts
    at a few lengths (the polynomial in S through them), equals a count of
    the whole step at S for flops, calls, minimum and aten bytes and the
    collective bytes; the peak is close (here within 2%)."""
    cfg = dryrun.arch_config(arch, smoke=True).replace(**overrides)
    shape = InputShape("prefill", S, 2, "prefill")
    once = functools.partial(dryrun._count_once_mesh, mesh_name="2x4")
    fitted, how = dryrun.seq_extrapolated_count(cfg, shape, once, seqs=seqs)
    direct = once(cfg, shape)
    assert how == {"depth": "full", "seq_points": list(seqs)}
    assert direct["coll_bytes:model"] > 0
    for key in direct:
        if key not in ("count_s", "peak_bytes"):
            assert fitted[key] == pytest.approx(direct[key], rel=1e-9, abs=1e-3), key
    assert fitted["peak_bytes"] == pytest.approx(direct["peak_bytes"], rel=0.02)


def test_dryrun_mesh_seq_points():
    """The full configs' prefill mesh records are counted at the 1 x 1
    count's sequence points; decode and the other families whole."""
    for arch in (XLSTM, ZAMBA):
        cfg = dryrun.arch_config(arch)
        shape = dryrun.INPUT_SHAPES["prefill_32k"]
        assert dryrun.mesh_seq_points(cfg, shape) == dryrun.count_points(cfg, shape)[1]
        steps = dryrun.steps_of(arch, "prefill_32k", mesh="16x16")
        assert [s[1].seq_len for s in steps] == list(dryrun.count_points(cfg, shape)[1])
        assert dryrun.mesh_seq_points(cfg, dryrun.INPUT_SHAPES["decode_32k"]) is None
    assert dryrun.mesh_seq_points(dryrun.arch_config(WHISPER),
                                  dryrun.INPUT_SHAPES["prefill_32k"]) is None
