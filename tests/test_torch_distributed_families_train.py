"""The port's sharded train step for the audio (whisper-small), hybrid
(zamba2-2.7b), ssm (xlstm-125m) and vlm (llava-next-mistral-7b) families on
a ("data", "model") mesh of CPU ranks (gloo, spawned by
``distributed.launch.run_on_mesh``, one thread each) at smoke widths in
f32, against the reference's sharded step and against the port's one-rank
step, with the families' inputs besides the tokens (``vision_embeds``,
``enc_states``) drawn by ``parity.numpy_lm_batch``: a vlm's labels cover its
patches and its text, -100 on the patches.

  * the reference's ``make_train_step`` runs unchanged in a subprocess with
    8 forced host devices on 2 x 4 (``REF_SCRIPT`` of
    tests/test_torch_distributed_train.py) for two steps of each family.
    Its weights and batch are carried to 8 ranks, where the port's step
    (2 x 4, with ``shard_h``, ZeRO-1 moments) equals it: loss, grad_norm,
    every parameter and both moments;
  * the port's sharded step against its one-rank step (``parity.train``),
    each family on (1, 4), (2, 2) and (2, 4), whisper and llava on
    (2, 2, 2), every gradient one by one, then every parameter and moment
    after each of two steps: on (2, 2) each family also with ``remat=True``
    and ``-100`` labels spread unevenly over the data ranks; on (1, 4)
    2 heads (whisper's do not divide the model axis, the xLSTM's and
    zamba2's split over two ranks); on (2, 4) whisper with vocab 511 (the
    embedding splits its width, the lm_head its rows) and zamba2 with two
    groups of two mamba layers under its shared block. The xLSTM cases carry
    ``slstm_every=2`` (an sLSTM layer among two) and ``d_model`` 192, so
    that the sLSTM's feed-forward width (256) splits over "model" while
    its recurrence runs whole on every rank;
  * ZeRO-1: each rank's parameter and moment bytes are the rules';
  * the dry run: the xLSTM's (with sLSTM) and zamba2's train mesh count on
    a fake 2 x 4 group, extrapolated in S, equals a count of the whole
    step; a mesh decode's minimum bytes per device are the rank's own
    (rows x slots of its cache block) in closed form, and the committed
    production-mesh records hold no ``RULES_ONLY`` record.

Tolerances are tests/test_torch_distributed_train.py's (each relative to
max(1, max |one-rank or reference|)): loss 1e-5, ``grad_norm`` 1e-4,
gradients 1e-5, parameters and moments 1e-4, and 2 lr a step where the
one-rank step took a clipped gradient within 100 eps of 0. Every launch of
ranks is cut at 60 s, the reference's subprocess at 120 s.
"""
import functools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed_train import (  # noqa: E402
    GRAD_TOL, LIMIT_S, _held, run_reference)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import parity  # noqa: E402
from repro_torch.distributed.launch import run_on_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WHISPER, ZAMBA, XLSTM, LLAVA = ("whisper-small", "zamba2-2.7b", "xlstm-125m",
                                "llava-next-mistral-7b")
# an sLSTM layer among the smoke config's two, its feed-forward width 256
SLSTM = {"slstm_every": 2, "d_model": 192}
FAMILY = [(WHISPER, {}), (LLAVA, {}), (ZAMBA, {}), (XLSTM, SLSTM)]
TWO_HEADS = {"n_heads": 2, "n_kv": 2}
REMAT = {"remat": True}


# (arch, config overrides, parity.train keywords) per mesh: each family on
# every mesh, some with a case's variation folded in
CASES = {(1, 4): [(WHISPER, TWO_HEADS, {}), (LLAVA, {}, {}), (ZAMBA, TWO_HEADS, {}),
                  (XLSTM, {**SLSTM, **TWO_HEADS}, {})],
         (2, 2): [(arch, over, {}) for arch, over in FAMILY]
         + [(arch, {**over, **REMAT}, {"uneven": True}) for arch, over in FAMILY],
         (2, 4): [(WHISPER, {"vocab": 511}, {}), (LLAVA, {}, {}),
                  (ZAMBA, {"n_layers": 4, "attn_every": 2, **REMAT}, {}), (XLSTM, SLSTM, {})],
         (2, 2, 2): [(WHISPER, {}, {"batch": 8}), (LLAVA, {}, {"batch": 8})]}
TRAIN_CASES = [(shape, i) for shape in CASES for i in range(len(CASES[shape]))]
# arch -> (config overrides, (text tokens a row, rows)) of the reference's run
REF_CASES = {arch: (over, (16, 8)) for arch, over in FAMILY}


@functools.cache
def mesh_run(shape):
    return run_on_mesh(parity.trains, shape, device="cpu", args=(CASES[shape],),
                       timeout=LIMIT_S)


def _case_id(case):
    shape, i = case
    arch, over, kw = CASES[shape][i]
    return f"{'x'.join(map(str, shape))}-{arch}" + "".join(
        f"-{k}{v}" for k, v in {**over, **kw}.items())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded step of each family on 8 host devices, and
    the port's on 2 x 4 ranks from its weights and batch (one launch)."""
    paths = run_reference(tmp_path_factory.mktemp("ref_families_train"), REF_CASES)
    cases = [(arch, over, dict(carried=paths[arch][0], want=paths[arch][1],
                               gather_moments=False)) for arch, (over, _) in REF_CASES.items()]
    ranks = run_on_mesh(parity.trains, (2, 4), device="cpu", args=(cases,), timeout=LIMIT_S)
    return {arch: [r[i] for r in ranks] for i, arch in enumerate(REF_CASES)}


@pytest.mark.parametrize("arch", list(REF_CASES))
def test_family_sharded_train_matches_reference_on_8_ranks(reference, arch):
    """Two steps of the port's step on 2 x 4 ranks (shard_h, ZeRO-1) from
    the reference's weights and batch (with its vision_embeds or
    enc_states) equal the reference's sharded step on 8 host devices:
    loss, grad_norm, every parameter and both moments."""
    for r in reference[arch]:
        assert {f"{k}_{i}" for k in ("params", "m", "v") for i in (1, 2)} <= set(r["errs"])
        _held(r)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_family_sharded_train_matches_one_rank(case):
    """Every parameter's gradient, then every parameter and moment after
    each of two steps, the loss and grad_norm, on every rank; each rank
    holds the rules' bytes of parameters and moments (ZeRO-1)."""
    shape, i = case
    for r in mesh_run(shape):
        got = r[i]
        assert got["errs"]["grads"] <= GRAD_TOL, (got["errs"], got["where"])
        _held(got)
        assert got["metrics"][1]["loss"] < got["metrics"][0]["loss"]
        assert got["held"]["params"] == got["rule"]["params"]
        assert got["held"]["opt"] == got["rule"]["opt"]
        assert got["held"]["grads"] == got["held"]["params"]


def test_vlm_labels_cover_patches_and_text():
    """numpy_lm_batch lays a vlm's labels over its patches (-100) and its
    text, and draws the extra inputs from the same seed on every call."""
    cfg = ARCHS[LLAVA].smoke()
    a = parity.numpy_lm_batch(1, cfg, 4, 16, uneven=True)
    b = parity.numpy_lm_batch(1, cfg, 4, 16, uneven=True)
    assert a["tokens"].shape == (4, 16) and a["labels"].shape == (4, cfg.n_patches + 16)
    assert (a["labels"][:, :cfg.n_patches] == -100).all()
    assert (a["labels"][0, cfg.n_patches + 1:] == -100).all()
    assert a["vision_embeds"].shape == (4, cfg.n_patches, cfg.d_model)
    assert all((a[k] == b[k]).all() for k in a)
    audio = parity.numpy_lm_batch(1, ARCHS[WHISPER].smoke(), 4, 16)
    assert audio["enc_states"].shape == (4, ARCHS[WHISPER].smoke().enc_len, 256)
    dense = parity.numpy_lm_batch(1, ARCHS["llama3.2-1b"].smoke(), 4, 16)
    assert set(dense) == {"tokens", "labels"}


# ------------------------------------------------------------- dry run ----

@pytest.mark.parametrize("arch,overrides,seqs,S", [
    (XLSTM, {**SLSTM, **REMAT}, (4, 8, 12), 16),     # an mLSTM (parallel form) and an sLSTM
    (ZAMBA, REMAT, (16, 32, 48), 64),                # one SSD chunk, the shared attention
])
def test_train_mesh_count_extrapolated_in_s_equals_the_whole_step(arch, overrides, seqs, S):
    """A recurrent family's train mesh count at full depth (remat on, as
    every published config), from counts at a few lengths, equals a count
    of the whole step at S for flops, calls, minimum and aten bytes and the
    collective bytes of both groups; the peak is close (here within 2%)."""
    cfg = dryrun.arch_config(arch, smoke=True).replace(**overrides)
    shape = InputShape("train", S, 2, "train")
    once = functools.partial(dryrun._count_once_mesh, mesh_name="2x4")
    fitted, how = dryrun.seq_extrapolated_count(cfg, shape, once, seqs=seqs)
    direct = once(cfg, shape)
    assert how == {"depth": "full", "seq_points": list(seqs)}
    assert direct["coll_bytes:model"] > 0 and direct["coll_bytes:data"] > 0
    for key in direct:
        if key not in ("count_s", "peak_bytes"):
            assert fitted[key] == pytest.approx(direct[key], rel=1e-9, abs=1e-3), key
    assert fitted["peak_bytes"] == pytest.approx(direct["peak_bytes"], rel=0.02)


def test_train_mesh_records_are_counted_at_the_1x1_points():
    """The full configs' train_4k mesh records of the recurrent families are
    counted at full depth at the 1 x 1 count's sequence points; whisper's
    and llava's whole."""
    shape = dryrun.INPUT_SHAPES["train_4k"]
    for arch in (XLSTM, ZAMBA):
        cfg = dryrun.arch_config(arch)
        points = dryrun.count_points(cfg, shape)[1]
        assert dryrun.mesh_seq_points(cfg, shape) == points
        steps = dryrun.steps_of(arch, "train_4k", mesh="16x16")
        assert [(s[0].n_layers, s[1].seq_len) for s in steps] == [
            (cfg.n_layers, S) for S in points]
    for arch in (WHISPER, LLAVA):
        assert dryrun.steps_of(arch, "train_4k", mesh="2x16x16") == [
            (dryrun.arch_config(arch), shape, "2x16x16", shape.seq_len)]


def _decode_closed_form(arch: str, shape_name: str, dp: int, M: int) -> dict:
    """What a rank's decode must move on a (dp, M) mesh, bf16, in closed
    form: its parameter blocks, with the embedding's rows of its batch rows
    in place of its table block; its rows x slots of k and v at the block's
    width read and its rows' new slot written; zamba2's recurrent state
    blocks read and written; its logits [rows, 1, V] written."""
    cfg = dryrun.arch_config(arch, smoke=True)
    shape = dryrun.INPUT_SHAPES[shape_name]
    mesh = make_mesh((dp, M), device="meta")
    shd = parity.shd
    specs = shd.param_shardings(cfg, mesh, kind="decode")
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    C = dryrun.steps.cache_context(cfg, shape)
    slots = C // M if C % M == 0 else C
    es = 2
    weights = sum(shd.shard_bytes(p, specs[n], mesh)
                  for n, p in shd.abstract_params(cfg).items() if n != "embed.e")
    weights += rows * (cfg.d_model if cfg.vocab % M == 0 else cfg.d_model // M) * es
    groups = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    slot = groups * cfg.n_kv * cfg.head_dim * es            # one row's slot of k (or v)
    state = 0
    if cfg.family == "hybrid":
        cache = shd.abstract_cache(cfg, shape)
        cspecs = shd.cache_shardings(cfg, shape, mesh, cache=cache)
        state = 2 * sum(shd.shard_bytes(cache[k], cspecs[k], mesh) for k in ("ssm", "conv"))
    out = {"weights": weights, "kv": 2 * rows * slots * slot, "new_slot": 2 * rows * slot,
           "state": state, "logits": rows * cfg.vocab * es}
    return {**out, "total": float(sum(out.values()))}


@pytest.mark.parametrize("arch,shape_name", [("llama3.2-1b", "decode_32k"),
                                             ("llama3.2-1b", "long_500k"),
                                             (ZAMBA, "decode_32k")])
def test_mesh_decode_min_bytes_are_the_ranks_own(arch, shape_name):
    """A mesh decode's minimum bytes per device on a fake 2 x 4 group are
    its closed form (the rank's rows and slots, not the whole batch's) and
    lie within the resident bytes plus what the step writes (the new slot,
    zamba2's new state and the logits); the 1 x 1 record is the same closed
    form over the whole cache and batch."""
    rec = dryrun.count(arch, shape_name, smoke=True, mesh="2x4")
    want = _decode_closed_form(arch, shape_name, 2, 4)
    assert rec["min_bytes_per_device"] == want["total"]
    writes = want["new_slot"] + want["state"] / 2 + want["logits"]
    assert rec["min_bytes_per_device"] <= rec["resident_bytes"]["total"] + writes
    one = dryrun.count(arch, shape_name, smoke=True)
    assert one["min_bytes_per_device"] == _decode_closed_form(arch, shape_name, 1, 1)["total"]
    assert want["kv"] < _decode_closed_form(arch, shape_name, 1, 1)["kv"]


def test_mesh_prefill_reads_the_ranks_embedding_rows():
    """A mesh prefill reads at most the rank's tokens of each embedding
    table's rows: zamba2's smoke prefill on 2 x 4, one row a rank, 64
    tokens against a table block of 128 rows (bf16, d = 256), counted at 64
    tokens for a record of 256 reads the record's 128 rows, 64 more than
    the 64-token record."""
    cfg = dryrun.arch_config(ZAMBA, smoke=True)
    shape = InputShape("prefill", 64, 2, "prefill")
    short = dryrun._count_once_mesh(cfg, shape, "2x4")
    as_256 = dryrun._count_once_mesh(cfg, shape, "2x4", seq_len=256)
    assert as_256["min_bytes"] - short["min_bytes"] == (128 - 64) * cfg.d_model * 2


def test_committed_mesh_records_count_every_train_step():
    """The production-mesh records in experiments/results/h100/
    (``launch/dryrun.py --all --both-meshes --collect`` on the chip host):
    no ``RULES_ONLY`` record; each family's train_4k record has a collective
    term over "model" and the data axes; a decode's minimum bytes a device
    lie within its resident bytes plus its logits, and plus its cache again
    where the cache holds a recurrent state (read and written)."""
    recs = json.loads((ROOT / "experiments/results/h100/dryrun_meshes.json").read_text())[
        "records"]
    assert {r["status"] for r in recs} <= {"OK", "DOES_NOT_FIT", "SKIP"}
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    for arch, _ in FAMILY:
        for mesh, data in (("16x16", "data"), ("2x16x16", "pod,data")):
            rec = by[(arch, "train_4k", mesh)]
            assert rec["status"] == "OK" and rec["roofline"]["collective_s"] > 0
            assert set(rec["roofline"]["collective"]["groups"]) == {"model", data}
    for (arch, shape_name, mesh), rec in by.items():
        shape = dryrun.INPUT_SHAPES[shape_name]
        if rec["status"] == "SKIP" or shape.kind != "decode":
            continue
        cfg = dryrun.arch_config(arch)
        dp = 16 if mesh == "16x16" else 32
        rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
        resident = rec["resident_bytes"]
        writes = rows * cfg.vocab * 2 + (resident["cache"] if cfg.family in ("ssm", "hybrid")
                                         else 0)
        assert rec["min_bytes_per_device"] <= resident["total"] + writes, (arch, shape_name)

