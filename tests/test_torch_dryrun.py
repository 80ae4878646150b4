"""The port's step counter (``launch/step_cost.py``) and dry run
(``launch/dryrun.py``) against the reference, on the smoke configs.

- param bytes equal the reference's ``init_model`` pytree bytes exactly,
  cache bytes its ``steps.cache_specs`` bytes, for every arch in bf16;
- ``model_flops`` equals ``repro.launch.dryrun.model_flops`` exactly;
- the counted matmul flops of llama3.2-1b.smoke()'s prefill step equal,
  within 2%, ``repro.launch.hlo_cost.analyze``'s dot flops of the
  reference's step compiled on one CPU device (the same computation: the
  reference's ``use_flash=False`` attention, the port's ``_sdpa`` on the
  CPU); with the kernels' route the attention counts 4·B·H·D per causal
  pair;
- the extrapolated count (layer units, sequence points) equals a count of
  the whole step for flops, calls and bytes;
- ``StageExecutor.cost`` is what it was before it moved onto step_cost;
- the launcher writes a record per (arch, shape) with a status, and runs
  one that fits; counting in worker processes changes no record.
"""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

# the reference's dry-run module sets XLA_FLAGS (512 host devices) when it is
# imported: restore the environment before any backend reads it, for later
# tests and their subprocesses
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.cluster import executor  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, step_cost  # noqa: E402

DECODE = [n for n, s in INPUT_SHAPES.items() if s.kind == "decode"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so that parallel test workers do not contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_cache_bytes_equal_reference(arch):
    cfg = dryrun.arch_config(arch, smoke=True)
    jcfg = JARCHS[arch].smoke().replace(dtype="bfloat16")
    want = _tree_bytes(jax.eval_shape(lambda k: japi.init_model(k, jcfg), jax.random.PRNGKey(0)))
    params = shd.abstract_params(cfg)
    assert sum(step_cost.nbytes(p) for p in params.values()) == want
    for name in DECODE:
        shape = INPUT_SHAPES[name]
        want = _tree_bytes(jsteps.cache_specs(jcfg, shape))
        cache = shd.abstract_cache(cfg, shape)
        assert sum(step_cost.nbytes(t) for t in step_cost.tensors(cache)) == want, name
        rec = dryrun.count(arch, name, smoke=True)
        if rec["status"] != "SKIP":
            assert rec["resident_bytes"]["cache"] == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_reference(arch):
    for shape in INPUT_SHAPES.values():
        for cfg, jcfg in ((ARCHS[arch], JARCHS[arch]),
                          (ARCHS[arch].smoke(), JARCHS[arch].smoke())):
            assert dryrun.model_flops(cfg, shape) == jdryrun.model_flops(jcfg, shape)


def test_prefill_matmul_flops_match_hlo_cost(monkeypatch):
    """The same prefill computation counted both ways: the reference's dot
    flops from its compiled HLO (trip counts included; elementwise ops not
    counted), the port's products from FlopCounterMode over its eager step.
    If they differ, the assertion names the largest op of the port's count."""
    shape = InputShape("p", 256, 2, "prefill")
    jcfg = JARCHS["llama3.2-1b"].smoke()
    pshape = jax.eval_shape(lambda k: japi.init_model(k, jcfg), jax.random.PRNGKey(0))
    hlo = jax.jit(jsteps.make_prefill_step(jcfg)).lower(
        pshape, jsteps.batch_specs(jcfg, shape)).compile().as_text()
    monkeypatch.setattr(hlo_cost, "_ELEMENTWISE", set())
    ref = hlo_cost.analyze(hlo)["flops"]

    cfg = ARCHS["llama3.2-1b"].smoke()          # use_flash=False: _sdpa, as the reference
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        step, args, inputs = dryrun.build_step(cfg, shape, "cpu")
        _, cost = step_cost.measure(step, *args, inputs=inputs)
        with FlopCounterMode(display=False) as counter:
            step(*args)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    err = abs(cost.flops - ref) / ref
    assert cost.attention_flops == 0 and err < 0.02, (
        f"port {cost.flops:.0f} vs hlo_cost {ref:.0f} ({err:.2%}); port by op {by_op}")

    # through the kernels' route: attention counted as the CUDA kernel
    # computes it, 4·B·H·D per causal pair, once per layer
    kcfg = cfg.replace(use_flash=True)
    with FakeTensorMode():
        step, args, inputs = dryrun.build_step(kcfg, shape, "cpu")
        _, kc = step_cost.measure(step, *args, inputs=inputs)
    B, S = shape.global_batch, shape.seq_len
    pairs = S * (S + 1) // 2
    assert kc.calls == {"flash_attention": cfg.n_layers, "decode_attention": 0}
    assert kc.attention_flops == cfg.n_layers * 4.0 * B * cfg.n_heads * cfg.head_dim * pairs
    square = cfg.n_layers * 4.0 * B * cfg.n_heads * cfg.head_dim * S * S
    assert kc.flops - kc.attention_flops == pytest.approx(cost.flops - square, rel=1e-12)


def test_attention_pairs():
    for S in (1, 7, 64, 300):
        idx = torch.arange(S)
        causal = idx[None, :] <= idx[:, None]
        assert step_cost.attention_pairs(S) == int(causal.sum())
        assert step_cost.attention_pairs(S, causal=False) == S * S
        for w in (1, 5, 64, 512):
            win = idx[None, :] > idx[:, None] - w
            assert step_cost.attention_pairs(S, window=w) == int((causal & win).sum())
            assert step_cost.attention_pairs(S, causal=False, window=w) == int(win.sum())


@pytest.mark.parametrize("arch,shape", [
    ("llama4-maverick-400b-a17b", "train_4k"),      # interleave blocks as units
    ("granite-moe-3b-a800m", "decode_32k"),
    ("zamba2-2.7b", "decode_32k"),
    ("whisper-small", "prefill"),                    # encoder states in the batch
    ("zamba2-2.7b", "prefill"),                      # units and the parabola in S
    ("zamba2-2.7b", "train"),
])
def test_extrapolated_count_equals_the_whole_step(arch, shape, monkeypatch):
    """Flops, calls, minimum and aten bytes of the extrapolated count equal
    the count of the whole step; the peak is close (here within 2%)."""
    small = {"prefill": InputShape("prefill", 4096, 1, "prefill"),
             "train": InputShape("train", 4096, 1, "train")}
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "prefill", small["prefill"])
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "train", small["train"])
    direct = dryrun.count(arch, shape, smoke=True, direct=True)
    fitted = dryrun.count(arch, shape, smoke=True)
    assert "seq_points" in fitted["counted_by"] and fitted["counted_by"]["of"] >= 1
    for key in ("flops_per_device", "attention_flops", "min_bytes_per_device",
                "aten_bytes_per_device"):
        assert fitted[key] == pytest.approx(direct[key], rel=1e-9, abs=1e-3), key
    assert fitted["attention_calls"] == direct["attention_calls"]
    assert fitted["peak_bytes"] == pytest.approx(direct["peak_bytes"], rel=0.02)


def test_count_all_in_worker_processes_equals_one_process():
    """Records whose steps were counted as separate jobs in spawned
    processes equal those counted in this one, but for the seconds."""
    archs, shapes = ["llama3.2-1b", "zamba2-2.7b", "xlstm-125m"], ["train_4k", "decode_32k"]
    serial = dryrun.count_all(archs, shapes, smoke=True, workers=1, log=lambda m: None)
    spawned = dryrun.count_all(archs, shapes, smoke=True, workers=2, log=lambda m: None)
    for one, two in zip(serial, spawned, strict=True):
        assert {**one, "count_s": 0} == {**two, "count_s": 0}
        assert two["count_s"] > 0


def _old_cost(entry):
    """StageExecutor.cost as it was before it moved onto step_cost."""
    from repro_torch.kernels import ops
    from torch.utils.flop_counter import FlopCounterMode
    B = entry.batch["tokens"].shape[0]
    before = ops.launch_counts()["decode_attention"]
    with FlopCounterMode(display=False) as counter:
        logits, _ = entry.eager()
    calls = ops.launch_counts()["decode_attention"] - before
    flops = float(counter.get_total_flops())
    if calls:
        C = entry.cache["k"].shape[2]
        flops += calls * 4.0 * B * entry.cfg.n_heads * C * entry.cfg.head_dim
    return {"flops": flops,
            "bytes": step_cost.step_bytes(entry.model, entry.cache, B, logits)}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small", "xlstm-125m", "zamba2-2.7b"])
def test_executor_cost_unchanged(arch, flash, monkeypatch):
    """On the CPU (the plain route; with ``use_flash`` the kernels' plain
    versions through ``kernels.ops``, whose products the old counter
    counted and the new one counts as 4·B·H·C·D per call)."""
    if flash:
        monkeypatch.setitem(executor.ARCHS, arch, ARCHS[arch].replace(use_flash=True))
    ex = executor.StageExecutor("cpu", seq_len=8, smoke=True)
    entry, _ = ex.compiled_step(arch, 2, "bf16")
    old = _old_cost(entry)
    new = ex.cost(entry)
    assert new == old
    assert entry.cost is new and ex.cost(entry) is new


def test_launcher_writes_a_record_per_pair_and_runs_one(tmp_path):
    dryrun.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--measure", "1",
                 "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert {r["shape"] for r in recs} == set(INPUT_SHAPES)
    for r in recs:
        assert r["status"] in ("OK", "DOES_NOT_FIT", "SKIP") and r["mesh"] == "1x1"
        assert r["roofline"]["collective_s"] is None
        assert r["flops_per_device"] > 0 and r["peak_bytes"] >= r["resident_bytes"]["params"]
    measured = [r for r in recs if "measured" in r]
    assert len(measured) == 1 and INPUT_SHAPES[measured[0]["shape"]].kind == "decode"
    assert measured[0]["measured"]["ms"] > 0
    assert measured[0]["measured"]["peak_bytes"] == "not measured"
    whisper = dryrun.count("whisper-small", "long_500k", smoke=True)
    assert whisper["status"] == "SKIP"
