"""The port's sharded program on a ("data", "model") mesh of CPU ranks
(gloo, spawned by ``distributed.launch.run_on_mesh``, one thread each) at
smoke widths, against the reference and against the one-rank program.

  * the expert-parallel MoE and its ep2d decode on 2 x 4, with the
    reference's ``MOE_EP_SCRIPT`` config and weights (tests/
    test_distributed.py): the reference runs unchanged in a subprocess with
    8 forced host devices, its weights and input carried to the ranks;
  * llama3.2-1b and granite-moe (and starcoder2-3b, whose 2 kv heads do
    not divide 4; and granite-moe with a vocab that does not divide, whose
    embedding and lm_head split the width; and llama3.2-1b decoding into a
    ring-buffer cache that wraps) on (1, 4), (2, 2) and (2, 4):
    ``forward`` with and without ``shard_h``, ``make_prefill_step``'s last
    position (the logits vocab-split until then) and 8 ``decode_step``s
    equal the one-rank run (MoE plans replayed), the bytes each rank holds equal
    the rules', and the blocks rebuild the whole parameters;
  * the decode kernel's plain version's log-sum-exp output, an all-masked
    row included, against a float64 softmax;
  * the dry run's sharded count on a fake 2 x 4 group: its collective bytes
    equal the closed-form sum over the program's all-reduces;
  * ``StageExecutor(mesh=)`` on two ranks against the one-rank executor;
  * a failing rank fails the launch.

Tolerance: f32, 1e-4 of max(1, max |reference|), the reference's EP bound;
the dry run's bytes exactly. Every launch of ranks is cut at 60 s
(``run_on_mesh(timeout=)``).
"""
import functools
import operator
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import parity  # noqa: E402
from repro_torch.distributed.launch import run_on_mesh  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

TOL = 1e-4
LIMIT_S = 60            # each launch of ranks, and the reference's subprocess
MESHES = [(1, 4), (2, 2), (2, 4)]
# (arch, config overrides, parity.decoder keywords) per mesh
ARCH_CASES = {(1, 4): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                       ("granite-moe-3b-a800m", {"vocab": 510}, {})],
              (2, 2): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                       ("llama3.2-1b", {}, {"ring": True})],
              (2, 4): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                       ("starcoder2-3b", {}, {})]}

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro import nn
    from repro.compat import make_mesh, use_mesh

    p = nn.init_moe(jax.random.PRNGKey(0), 32, 64, 16)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
    y_local, aux_local = nn.moe(p, x, top_k=2)
    mesh = make_mesh((2, 4), ("data", "model"))
    with use_mesh(mesh):
        y_ep, aux_ep = jax.jit(lambda p_, x_: nn.moe(p_, x_, top_k=2))(p, x)
        y_2d, aux_2d = jax.jit(lambda p_, x_: nn.moe(p_, x_, top_k=2, ep2d=True))(p, x)
    np.savez(sys.argv[1], router=np.asarray(p["router"]["w"]),
             wg=np.asarray(p["experts"]["wg"]), wu=np.asarray(p["experts"]["wu"]),
             wd=np.asarray(p["experts"]["wd"]), x=np.asarray(x),
             y_local=np.asarray(y_local), lb_local=float(aux_local["lb_loss"]),
             y_ep=np.asarray(y_ep), lb_ep=float(aux_ep["lb_loss"]),
             y_2d=np.asarray(y_2d), lb_2d=float(aux_2d["lb_loss"]))
""")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's MoE config run on 8 forced host devices -> (the
    .npz's path, its weights, input, local, EP and ep2d outputs)."""
    out = tmp_path_factory.mktemp("ref") / "moe.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], capture_output=True,
                         text=True, timeout=LIMIT_S, cwd=root,
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    return str(out), dict(np.load(out))


@pytest.mark.parametrize("ep2d", [False, True], ids=["ep", "ep2d"])
def test_moe_on_8_ranks_matches_reference(reference, ep2d):
    path, reference = reference             # the ranks load the carried weights from path
    got = run_on_mesh(parity.moe_layer, (2, 4), device="cpu", args=(path, 2, ep2d),
                      timeout=LIMIT_S)[0]
    want_y, want_lb = ((reference["y_2d"], reference["lb_2d"]) if ep2d else
                       (reference["y_ep"], reference["lb_ep"]))
    assert rel(got["y"], want_y) <= TOL
    assert abs(got["lb_loss"] - float(want_lb)) <= TOL
    assert rel(got["y"], got["y_one"]) <= TOL
    assert abs(got["lb_loss"] - got["lb_loss_one"]) <= TOL
    assert rel(got["y_one"], reference["y_local"]) <= TOL


@functools.cache
def mesh_run(shape):
    return run_on_mesh(parity.decoders, shape, device="cpu", args=(ARCH_CASES[shape],),
                       timeout=LIMIT_S)


CASES = [(shape, i) for shape in MESHES for i in range(len(ARCH_CASES[shape]))]


def _case_id(case):
    shape, i = case
    arch, over, kw = ARCH_CASES[shape][i]
    return f"{'x'.join(map(str, shape))}-{arch}" + "".join(
        f"-{k}{v}" for k, v in {**over, **kw}.items())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_model_matches_one_rank(case):
    """forward (with and without shard_h) and 8 decode steps on the mesh
    equal the one-rank run."""
    shape, i = case
    res = mesh_run(shape)
    errs = res[0][i]["errs"]
    assert max(errs.values()) <= TOL, errs
    assert all(r[i]["finite"] for r in res)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_place_holds_the_rules_block(case):
    """Every rank holds exactly its block: its bytes are the rules' bytes
    per device, and the blocks of all ranks rebuild every parameter."""
    shape, i = case
    for r in mesh_run(shape):
        got = r[i]
        assert got["param_bytes"] == got["param_bytes_rule"]
        assert got["cache_bytes"] == got["cache_bytes_rule"]
        assert got["blocks_err"] == 0.0
    arch, over, _ = ARCH_CASES[shape][i]
    cfg = ARCHS[arch].smoke().replace(**over)
    whole = sum(p.numel() * p.element_size()
                for p in parity.shd.abstract_params(cfg).values())
    if shape[1] > 1:
        assert mesh_run(shape)[0][i]["param_bytes"] < whole


def test_stage_executor_on_a_mesh_matches_one_rank():
    """StageExecutor(mesh=) on two ranks: its serving step and a prefill
    with shard_h equal the one-rank executor's; the mesh enters the cache
    key and the calibration label; the entry runs eager."""
    ranks = run_on_mesh(parity.stage, (1, 2), device="cpu", args=("granite-moe-3b-a800m",),
                        kwargs=dict(smoke=True, steps=4), timeout=LIMIT_S)
    assert max(ranks[0]["errs"].values()) <= TOL, ranks[0]["errs"]
    for r in ranks:
        assert r["finite"] and r["backend"] == "gloo" and r["device_class"] == "cpu2"
        assert r["cache_key_mesh"] == [("data", 1), ("model", 2)]
        assert r["step_ms"] == ranks[0]["step_ms"] > 0          # the slowest rank's


def test_decode_plain_lse_against_float64_softmax():
    g = torch.Generator().manual_seed(3)
    B, C, H, Hkv, D = 3, 40, 8, 2, 64
    q = torch.randn(B, 1, H, D, generator=g)
    k = torch.randn(B, C, Hkv, D, generator=g)
    v = torch.randn(B, C, Hkv, D, generator=g)
    mask = torch.rand(B, C, generator=g) < 0.5
    mask[1] = False                                   # a row with no valid slot
    out, lse = ref.decode_attention_ref(q, k, v, mask, return_lse=True)
    logits = torch.einsum("bhd,bchd->bhc", q[:, 0].double(),
                          k.double().repeat_interleave(H // Hkv, dim=2)) / D ** 0.5
    logits = logits.masked_fill(~mask[:, None, :], -torch.inf)
    want_lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    want = torch.einsum("bhc,bchd->bhd", probs, v.double().repeat_interleave(H // Hkv, 2))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H)
    assert torch.isneginf(lse[1]).all() and (out[1] == 0).all()
    keep = torch.tensor([0, 2])
    assert (lse[keep].double() - want_lse[keep]).abs().max() <= 1e-5
    assert (out[:, 0].double() - want).abs().max() <= 1e-5
    plain = ref.decode_attention_ref(q, k, v, mask)
    assert torch.equal(plain[keep], out[keep])
    assert torch.allclose(plain[1], v[1].mean(0).repeat_interleave(H // Hkv, 0)[None], atol=1e-6)


def _closed_form(arch: str, shape_name: str, M: int, dp: int) -> float:
    """Bytes per device the smoke arch's sharded step moves on a (dp, M)
    mesh, from its all-reduces: a ring all_reduce of n bytes over g ranks
    moves 2(g - 1)/g n. Dense smoke config in bf16, every width divides M."""
    cfg = dryrun.arch_config(arch, smoke=True)
    shp = dryrun.INPUT_SHAPES[shape_name]
    B, S, d, V, L = shp.global_batch // dp, shp.seq_len, cfg.d_model, cfg.vocab, cfg.n_layers
    H, Hkv, D, es = cfg.n_heads, cfg.n_kv, cfg.head_dim, 2
    if shp.kind == "prefill":
        # embedding, each layer's wo and mlp sums, L sequence gathers (layers
        # 1.. and the last), the last position's vocab-split logits (the
        # rest stay split), the cache's k/v heads
        n = B * S * d * es * (1 + 2 * L + L) + B * V * es + 2 * L * B * S * Hkv * D * es
    else:
        # embedding, per layer: q, k, v gathers, lse max, (out, weight) sum,
        # wo and mlp sums; the logits
        per_layer = B * (H + 2 * Hkv) * D * es + B * H * 4 + B * (H * D + H) * 4 + 2 * B * d * es
        n = B * d * es + L * per_layer + B * V * es
    return 2 * (M - 1) / M * n


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_dryrun_counts_collectives_on_fake_8_rank_group(shape_name):
    rec = dryrun.count("llama3.2-1b", shape_name, smoke=True, mesh="2x4")
    assert rec["status"] == "OK" and rec["mesh"] == "2x4"
    groups = rec["roofline"]["collective"]["groups"]
    assert set(groups) == {"model"}
    assert groups["model"]["bytes_per_device"] == _closed_form("llama3.2-1b", shape_name, 4, 2)
    assert groups["model"]["bytes_per_s"] == dryrun.LINKS["nvlink"][1]
    assert rec["roofline"]["collective_s"] == pytest.approx(
        groups["model"]["bytes_per_device"] / dryrun.LINKS["nvlink"][1])
    assert rec["flops_per_device"] > 0
    full = dryrun.count("llama3.2-1b", shape_name, smoke=True)
    assert rec["resident_bytes"]["params"] < full["resident_bytes"]["params"]


def test_dryrun_names_why_a_term_is_missing():
    """No reason is left to name: every family runs its sharded program on
    a mesh, the train step included. The audio, hybrid, ssm and vlm
    families' train_4k mesh records are counted, OK, with a collective
    term whose groups include "data" (the gradient sum and the ZeRO
    gathers); their prefill and decode records too, over "model"."""
    for arch in ARCHS:
        cfg = dryrun.arch_config(arch, smoke=True)
        for shape_name, shape in dryrun.INPUT_SHAPES.items():
            assert dryrun.sharded_program(cfg, shape) is None, (arch, shape_name)
    for arch in ("whisper-small", "zamba2-2.7b", "xlstm-125m", "llava-next-mistral-7b"):
        rec = dryrun.count(arch, "train_4k", smoke=True, mesh="2x4")
        assert rec["status"] == "OK", (arch, rec.get("reason"))
        assert rec["roofline"]["collective_s"] > 0
        assert {"data", "model"} <= set(rec["roofline"]["collective"]["groups"]), arch
        assert rec["resident_bytes"]["params"] > 0 and "opt" in rec["resident_bytes"]
        for shape_name in ("prefill_32k", "decode_32k"):
            rec = dryrun.count(arch, shape_name, smoke=True, mesh="2x4")
            assert rec["status"] == "OK", (arch, shape_name)
            assert rec["roofline"]["collective_s"] > 0
            assert set(rec["roofline"]["collective"]["groups"]) == {"model"}
    assert dryrun.link_of("16x16", ("model",)) == "ib"
    assert dryrun.link_of("2x4", ("data", "model")) == "nvlink"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_keeps_logits_vocab_split(case):
    """make_prefill_step on the mesh: the forward's logits stay the rank's
    vocab block (V / M wide where the lm_head is vocab-split) until the
    last position is taken, and that position equals the one-rank one."""
    shape, i = case
    arch, over, _ = ARCH_CASES[shape][i]
    cfg = ARCHS[arch].smoke().replace(**over)
    M = shape[1]
    res = mesh_run(shape)
    assert res[0][i]["errs"]["prefill_last"] <= TOL
    for r in res:
        assert r[i]["prefill_logits_width"] == (cfg.vocab // M if cfg.vocab % M == 0
                                                else cfg.vocab)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="not subscriptable"):
        run_on_mesh(operator.getitem, (1, 2), device="cpu", args=(0,), timeout=LIMIT_S)
