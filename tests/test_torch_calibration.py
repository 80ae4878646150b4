"""Port's measured stage execution and calibration vs the JAX package's, on
the CPU.

Bit for bit (the reference computes them in NumPy): the ``(alpha, beta)``
fit, its clamps and errors, the table's JSON round trip and payload
loading, ``from_timings``, ``calibrate_pipeline``'s variants, and under one
explicit table registered in both packages under one name: the calibrated
``PipelineSpec.build()``, ``pipeline_metrics``, the vectorized env's tables
and ``PipelineEnv`` rewards; ``apply_to_cluster`` and the analytic default
likewise. The port's ``resolve_table(None)`` raises (the reference loads a
CPU-mesh table there). ``quantize_params`` equals the reference's on
carried weights for bf16, int8 and int4 (a layer-stacked leaf shares one
scale across its layers, as the reference's [L, ...] array does). Within
tolerance: the quantised serve step's logits against the reference's jitted step at 4e-2
of the logits' max-abs (bf16 activations, two layers), and
``ops.decode_attention`` with bf16 q over an f32 cache against the Pallas
kernel in interpret mode at 4e-2 (the bf16 kernel tolerance of
``tests/test_kernels.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.cluster import calibration as jcal  # noqa: E402
from repro.cluster import env as jenv  # noqa: E402
from repro.cluster import executor as jexecutor  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import mdp as jmdp  # noqa: E402
from repro.core import vecenv as jvecenv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro_torch import api, timing  # noqa: E402
from repro_torch.cluster import calibration as cal  # noqa: E402
from repro_torch.cluster import env, executor  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import mdp, vecenv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import calibrate  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

SERVE2 = ("whisper-small", "xlstm-125m", "llama3.2-1b", "starcoder2-3b")
QUANT_TOL = 4e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size models: one intra-op thread, no contention with other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(fn_name, *args, **kw):
    return getattr(jcal, fn_name)(*args, **kw), getattr(cal, fn_name)(*args, **kw)


# ------------------------------------------------------------------ fit --

FIT_CASES = [
    ([1, 2, 4, 8, 16], list(3.5e-3 + 2.4e-4 * np.array([1, 2, 4, 8, 16])
                            + np.random.default_rng(0).normal(0, 1e-6, 5))),
    ([2, 4, 8], [0.01 + 0.002 * x for x in (2, 4, 8)]),
    ([1, 2, 4], [0.03, 0.02, 0.01]),                   # decreasing: beta clamps to 0
    ([1, 2, 4], [-0.01, 0.02, 0.05]),                  # negative intercept: alpha clamps
    ([4], [0.02]),                                      # one point: flat
    ([4, 4], [0.02, 0.04]),                             # one batch size: flat at the mean
]


@pytest.mark.parametrize("b,y", FIT_CASES)
def test_fit_alpha_beta_bit_for_bit(b, y):
    want, got = both("fit_alpha_beta", b, y)
    assert got == want
    assert got[0] >= 0.0 and got[1] >= 0.0
    pw, pg = both("predict", *got, b)
    assert np.array_equal(pw, pg)
    if min(y) > 0:
        ew, eg = both("mean_relative_error", pg, y)
        assert eg == ew


def test_fit_round_trip_recovers_alpha_beta():
    b, y = FIT_CASES[0]
    a_fit, b_fit = cal.fit_alpha_beta(b, y)
    assert a_fit == pytest.approx(3.5e-3, rel=1e-2)
    assert b_fit == pytest.approx(2.4e-4, rel=1e-2)
    assert cal.mean_relative_error(cal.predict(a_fit, b_fit, b), y) < 1e-3


def test_fit_shape_mismatch_raises():
    for args in (([1, 2], [0.1]), ([], []), ([[1, 2]], [[0.1, 0.2]])):
        with pytest.raises(ValueError):
            cal.fit_alpha_beta(*args)


# ---------------------------------------------------------------- table --

TABLE = dict(device_class="cuda1",
             variants={"llama3.2-1b:bf16": (0.002, 0.0003),
                       "whisper-small:bf16": (0.004, 0.0001),
                       "xlstm-125m:bf16": (0.0015, 0.00002),
                       "starcoder2-3b:bf16": (0.0055, 0.0004)},
             speeds={"cuda1": 1.0, "cpu1": 0.05}, meta={"mode": "full"})


def tables():
    return jcal.CalibrationTable(**TABLE), cal.CalibrationTable(**TABLE)


def test_table_json_round_trip_identical():
    jt, tt = tables()
    assert json.dumps(tt.to_dict()) == json.dumps(jt.to_dict())
    d = json.loads(json.dumps(tt.to_dict()))
    assert cal.CalibrationTable.from_dict(d) == tt
    assert dataclasses.asdict(cal.CalibrationTable.from_dict(jt.to_dict())) == \
        dataclasses.asdict(jt)


def test_load_accepts_payload_and_resolves_name_and_path(tmp_path):
    _, tt = tables()
    p = tmp_path / "calibration.json"
    p.write_text(json.dumps({"fit_mre_mean": 0.1, "table": tt.to_dict()}))
    assert cal.CalibrationTable.load(p) == tt
    assert dataclasses.asdict(jcal.CalibrationTable.load(p)) == dataclasses.asdict(tt)
    cal.register_table("port-test-table", tt)
    assert cal.resolve_table("port-test-table") is tt
    tt.save(tmp_path / "t.json")
    assert cal.resolve_table(str(tmp_path / "t.json")) == tt
    with pytest.raises(KeyError, match="unknown calibration table"):
        cal.resolve_table("no-such-table")


def test_resolve_table_none_raises_and_names_the_command():
    """The reference's default is its CPU-mesh table; the port has none."""
    with pytest.raises(KeyError, match="repro_torch.launch.calibrate"):
        cal.resolve_table(None)
    with pytest.raises(KeyError, match="no default table"):
        api.replace(api.get_pipeline("serve2"), perf_source="calibrated").build()


def stage_timings(mod, cls_of):
    rng = np.random.default_rng(4)
    return [mod.StageTiming(arch=a, batch=b, quant=q, backend="reference",
                            device_class=cls_of(i), latency_s=float(1e-3 * b + rng.random()),
                            compile_s=0.0, cache_hit=False, flops=1.0, bytes=1.0)
            for i, (a, q, b) in enumerate((a, q, b) for a in SERVE2 for q in ("bf16", "int8")
                                          for b in (1, 2, 4, 8))]


def test_from_timings_bit_for_bit_and_rejects_mixed_classes():
    want = jcal.CalibrationTable.from_timings(stage_timings(jexecutor, lambda i: "cuda1"),
                                              speeds={"cuda1": 1.0})
    got = cal.CalibrationTable.from_timings(stage_timings(executor, lambda i: "cuda1"),
                                            speeds={"cuda1": 1.0})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(got.variants) == 8
    with pytest.raises(ValueError, match="device classes"):
        cal.CalibrationTable.from_timings(
            stage_timings(executor, lambda i: f"cuda{1 + i % 2}"))


# ------------------------------------------------------- perf_source switch --

def spec(ns, **kw):
    return ns.api.PipelineSpec(name="t", stages=(("whisper-small", "xlstm-125m"),
                                                 ("llama3.2-1b", "starcoder2-3b")),
                               quants=("bf16", "int8"), **kw)


NS_REF = type("R", (), {"api": japi})
NS_PORT = type("P", (), {"api": api})


def test_spec_round_trip_and_pre_calibration_dicts():
    s = spec(NS_PORT, perf_source="calibrated", calibration="some-table")
    again = api.PipelineSpec.from_dict(json.loads(json.dumps(s.to_dict())))
    assert again == s and again.calibration == "some-table"
    assert json.dumps(s.to_dict(), sort_keys=True) == json.dumps(
        spec(NS_REF, perf_source="calibrated", calibration="some-table").to_dict(),
        sort_keys=True)
    d = spec(NS_PORT).to_dict()
    del d["perf_source"], d["calibration"]
    assert api.PipelineSpec.from_dict(d).perf_source == "analytic"


def test_analytic_default_bit_for_bit():
    assert dataclasses.asdict(spec(NS_PORT).build()) == dataclasses.asdict(
        spec(NS_REF).build())


def register_both(name="port-parity-table"):
    jt, tt = tables()
    jcal.register_table(name, jt)
    cal.register_table(name, tt)
    return name


def test_calibrated_build_bit_for_bit_and_partial_coverage():
    name = register_both()
    jp = spec(NS_REF, perf_source="calibrated", calibration=name).build()
    tp = spec(NS_PORT, perf_source="calibrated", calibration=name).build()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    by_name = {v.name: v for t in tp.tasks for v in t.variants}
    assert (by_name["llama3.2-1b:bf16"].alpha, by_name["llama3.2-1b:bf16"].beta) == \
        TABLE["variants"]["llama3.2-1b:bf16"]
    analytic = {v.name: v for t in spec(NS_PORT).build().tasks for v in t.variants}
    assert by_name["whisper-small:int8"] == analytic["whisper-small:int8"]
    assert cal.coverage(tp, tables()[1]) == (4, 8)
    assert cal.coverage(api.get_pipeline("serve2").build(), tables()[1]) == (4, 4)


def random_configs(pipe, n, seed):
    rng = np.random.default_rng(seed)
    bc = pipe.batch_choices()
    return [(tuple(int(rng.integers(0, len(t.variants))) for t in pipe.tasks),
             tuple(int(rng.integers(1, pipe.f_max + 1)) for _ in pipe.tasks),
             tuple(int(bc[rng.integers(0, len(bc))]) for _ in pipe.tasks),
             float(rng.uniform(1.0, 200.0))) for _ in range(n)]


def test_calibrated_metrics_vecenv_tables_and_rewards_bit_for_bit():
    name = register_both()
    jp = spec(NS_REF, perf_source="calibrated", calibration=name).build()
    tp = spec(NS_PORT, perf_source="calibrated", calibration=name).build()
    for z, f, b, demand in random_configs(tp, 40, 1):
        want = jmdp.pipeline_metrics(jp, jmdp.Config(z=z, f=f, b=b), demand)
        got = mdp.pipeline_metrics(tp, mdp.Config(z=z, f=f, b=b), demand)
        assert got == want
    jt, tt = jvecenv.tables_from_pipeline(jp), vecenv.tables_from_pipeline(tp)
    for field in ("alpha", "beta", "accuracy", "cost", "resource"):
        assert np.array_equal(np.asarray(getattr(jt, field)), getattr(tt, field).numpy())
    # stage 1's variants, arch-major over quants: starcoder2-3b:bf16 is third
    assert float(tt.alpha[1, 2]) == np.float32(0.0055)
    trace = np.abs(np.sin(np.arange(200) / 9.0)) * 60.0 + 2.0
    rewards = []
    for ns_env, ns_mdp, pipe in ((jenv, jmdp, jp), (env, mdp, tp)):
        e = ns_env.PipelineEnv(pipe, trace, seed=3)
        rs = []
        for z, f, b, _ in random_configs(pipe, 12, 2):
            _, r, _, _ = e.step(ns_mdp.Config(z=z, f=f, b=b))
            rs.append(r)
        rewards.append(rs)
    assert rewards[1] == rewards[0]


def test_calibration_propagates_through_pipeline_metrics():
    pipe = spec(NS_PORT).build()
    slow = cal.CalibrationTable(device_class="cuda1", variants={
        v.name: (v.alpha * 10.0, v.beta * 10.0) for t in pipe.tasks for v in t.variants})
    c = mdp.Config(z=(0, 0), f=(1, 1), b=(4, 4))
    *_, lat0, _, cap0 = mdp.pipeline_metrics(pipe, c, 10.0)
    *_, lat1, _, cap1 = mdp.pipeline_metrics(cal.calibrate_pipeline(pipe, slow), c, 10.0)
    assert cap1 == pytest.approx(cap0 / 10.0) and lat1 > lat0


def test_apply_to_cluster_bit_for_bit():
    jt, tt = tables()
    class_map = {"server": "cuda1", "device": "cpu1"}
    want = jcal.apply_to_cluster(japi.get_cluster("edge-hetero-3"), jt, class_map)
    got = cal.apply_to_cluster(api.get_cluster("edge-hetero-3"), tt, class_map)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    by_class = {n.device_class: n.speed for n in got.nodes}
    assert by_class["server"] == 1.0 and by_class["device"] == 0.05


def test_unknown_perf_source_raises():
    with pytest.raises(ValueError, match="perf_source"):
        spec(NS_PORT, perf_source="measured").build()


# --------------------------------------------------------------- timing --

def test_timing_min_of_k_and_mean():
    calls = []
    t = timing.time_fn(lambda: calls.append(1), reps=3, warmup=2)
    assert len(calls) == 5 and len(t.times) == 3
    assert t.best == min(t.times) <= t.mean


def test_timing_interleaved_orders_and_reps():
    order = []
    ts = timing.time_interleaved([lambda: order.append("a"), lambda: order.append("b")],
                                 reps=2, warmup=1)
    assert order == ["a", "b", "a", "b", "a", "b"]
    assert all(len(t.times) == 2 for t in ts)


def test_timing_validates_reps_and_never_syncs_the_cpu(monkeypatch):
    with pytest.raises(ValueError):
        timing.time_fn(lambda: None, reps=0)

    def boom(*a, **k):
        raise AssertionError("synchronised a CUDA device on a CPU timing")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert timing.time_fn(lambda: None, reps=2, device="cpu").best >= 0.0


# ------------------------------------------------------------- executor --

def test_executor_cache_second_measure_builds_nothing():
    ex = executor.StageExecutor("cpu", seq_len=8, smoke=True)
    t1 = ex.measure("whisper-small", 2, reps=1, warmup=0)
    entry = ex.cache.entries[ex.key_for("whisper-small", 2)]
    t2 = ex.measure("whisper-small", 2, reps=1, warmup=0)
    assert not t1.cache_hit and t2.cache_hit and t2.compile_s == 0.0
    assert ex.cache.entries[ex.key_for("whisper-small", 2)] is entry
    assert (ex.cache.hits, ex.cache.misses) == (1, 1) and ex.cache.hit_rate() == 0.5
    assert not ex.measure("whisper-small", 4, reps=1, warmup=0).cache_hit
    # on the CPU there is no graph: the latency is the eager step's
    assert entry.graph is None and t1.latency_s == t1.eager_latency_s > 0.0
    assert t1.device_class == ex.device_class == "cpu1" and t1.replays == 0
    assert t1.flops > 0.0 and t1.bytes > 0.0
    assert len(ex._params) == 1      # weights built once per (arch, quant)


def test_executor_flops_and_bytes_by_formula():
    """FlopCounterMode's products (the plain attention included on the CPU)
    and the byte formula, against the step's own shapes."""
    ex = executor.StageExecutor("cpu", seq_len=8, smoke=True)
    t = ex.measure("llama3.2-1b", 2, "bf16", reps=1, warmup=0)
    cfg = ex.arch_config("llama3.2-1b")
    model = ex.params_for("llama3.2-1b", "bf16")
    emb = model.embed.e
    w = sum(p.numel() for p in model.parameters()) - emb.numel()
    # every [in, out] weight is one product per row; attention over C = 8 slots
    dense = 2.0 * 2 * (w - sum(p.numel() for n, p in model.named_parameters()
                              if ".g" in n or n.endswith(".b")))
    attn = cfg.n_layers * 4.0 * 2 * cfg.n_heads * 8 * cfg.head_dim
    assert t.flops == dense + attn
    # k and v of every layer, one slot of each of the 2 rows in f32: the one
    # valid slot (pos = 0) read, the new slot written
    slot = 2 * cfg.n_layers * 2 * cfg.n_kv * cfg.head_dim * 4
    want = 2 * w + 2 * emb.shape[1] * 2 + slot + slot + 2 * cfg.vocab * 2
    assert t.bytes == want


@pytest.mark.parametrize("name", ["llama3.2-1b", "xlstm-125m"])
@pytest.mark.parametrize("quant", ["bf16", "int8", "int4"])
def test_quantize_params_matches_reference(quant, name):
    """Stacked layers (dense) and a list of unlike layers (xLSTM)."""
    cfg, jcfg = ARCHS[name].smoke(), JARCHS[name].smoke()
    jp = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(models.init_model(0, cfg, device="cpu"),
                            jax.tree.map(np.asarray, jp))
    executor.quantize_params(model, quant)
    # the reference's quantised leaves, widened exactly to f32, in the port's layout
    want = load_jax_params(models.init_model(0, cfg, device="cpu"), jax.tree.map(
        lambda x: np.asarray(x, np.float32), jexecutor.quantize_params(jp, quant)))
    for (n, got), (_, ref) in zip(model.named_parameters(), want.named_parameters(),
                                  strict=True):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), ref), n
        if quant != "bf16":
            qmax = 2 ** ({"int8": 8, "int4": 4}[quant] - 1)
            assert len(torch.unique(got)) <= 2 * qmax, n


def test_quantize_params_rejects_unknown_quant():
    with pytest.raises(ValueError, match="unknown quant"):
        executor.quantize_params(torch.nn.Linear(2, 2), "fp8")


@pytest.mark.parametrize("name", SERVE2)
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quantised_serve_step_matches_reference(name, quant):
    """bf16 activations against an f32 cache and recurrent state, as the
    reference promotes them; the step's logits within 4e-2 of max-abs."""
    jcfg, cfg = JARCHS[name].smoke(), ARCHS[name].smoke()
    jp = jexecutor.quantize_params(jmodels.init_model(jax.random.PRNGKey(2), jcfg), quant)
    model = load_jax_params(models.init_model(0, cfg, device="cpu"),
                            jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    executor.quantize_params(model, "bf16")          # already on the grid: exact
    jshape = JShape("serve_b3", 8, 3, "decode")
    shape = InputShape("serve_b3", 8, 3, "decode")
    ctx = max(steps.cache_context(cfg, shape), 1)
    jcache = jmodels.init_cache(jcfg, 3, ctx)
    tcache = models.init_cache(cfg, 3, ctx, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    jl, _ = jax.jit(jsteps.make_serve_step(jcfg, jshape))(jp, {"tokens": jnp.asarray(toks)},
                                                          jcache)
    with torch.inference_mode():
        tl, _ = steps.make_serve_step(cfg, shape)(model, {"tokens": torch.from_numpy(toks)},
                                                  tcache)
    want = np.asarray(jl, dtype=np.float32)
    assert tl.dtype == torch.bfloat16 and tl.shape == want.shape
    assert np.abs(want - tl.float().numpy()).max() <= QUANT_TOL * np.abs(want).max()


def test_mixed_dtype_decode_attention_matches_pallas_kernel():
    """bf16 q over an f32 cache, as a quantised decode step hands it over:
    widened exactly, attended in f32, returned in bf16, as the Pallas
    kernel computes it (interpret mode)."""
    rng = np.random.default_rng(8)
    B, C, H, Hkv, D = 2, 64, 8, 2, 64
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, Hkv, D)).astype(np.float32) for _ in range(2))
    mask = np.arange(C)[None, :] < np.array([[17], [64]])
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = jops.decode_attention(jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = ops.decode_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert np.abs(np.asarray(want, np.float32) - got.float().numpy()).max() < QUANT_TOL
    # widening is exact: the same as handing the kernel an f32 q
    f32 = ops.decode_attention(tq.float(), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(mask))
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_decode_attention_refuses_other_dtype_mixes():
    q = torch.zeros(1, 1, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    mask = torch.ones(1, 8, dtype=torch.bool)
    for qq, kk, vv in ((q, kv.bfloat16(), kv.bfloat16()), (q.bfloat16(), kv, kv.bfloat16()),
                       (q.half(), kv, kv)):
        with pytest.raises(ValueError, match=f"q {qq.dtype}, k {kk.dtype}"):
            ops.decode_attention(qq, kk, vv, mask)


def test_calibrate_launcher_on_cpu(tmp_path, capsys):
    """The grid's payload keys, the repeat pass's hits and a table that a
    calibrated spec loads, on smoke configs."""
    payload = calibrate.main(["--device", "cpu", "--smoke", "--batches", "1", "2",
                              "--reps", "1", "--archs", "xlstm-125m", "llama3.2-1b",
                              "--out", str(tmp_path)])
    assert set(payload["variants"]) == {f"{a}:{q}" for a in ("xlstm-125m", "llama3.2-1b")
                                        for q in ("bf16", "int8")}
    v = payload["variants"]["llama3.2-1b:bf16"]
    for key in ("measured_s", "eager_s", "fitted", "fit_mre", "analytic", "analytic_mre",
                "roofline_s"):
        assert key in v
    assert payload["cache"]["hit_rate_repeat"] == 1.0 and payload["speeds"] == {"cpu1": 1.0}
    assert all(r["share"] is None and r["graph_s"] is None for r in payload["rows"])
    table = cal.resolve_table(str(tmp_path / "table.json"))
    assert table.meta["device_name"] == "cpu" and len(table.variants) == 4
    pipe = api.PipelineSpec(name="t", stages=(("xlstm-125m", "llama3.2-1b"),),
                            quants=("bf16",), perf_source="calibrated",
                            calibration=str(tmp_path / "calibration.json")).build()
    assert [v.alpha for v in pipe.tasks[0].variants] == [
        table.variants[n][0] for n in ("xlstm-125m:bf16", "llama3.2-1b:bf16")]
    assert "hit_rate_repeat 1.0000" in capsys.readouterr().out
