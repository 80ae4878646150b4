"""paper-4stage served live in bf16 (``Session(..., dtype="bfloat16")``) on
the CPU, at the smoke configs, against the reference.

- A real run's virtual-time results (rewards, configs, the per-interval
  metrics and the summary) equal the port's ``real=False`` run and the
  reference's ``real=False`` report bit for bit: the reference computes
  them in NumPy, and the live bf16 executors never move the virtual clock.
- With the reference's weights carried across (``load_jax_params``), each
  stage's forward logits equal the reference's ``StageServer`` model on
  ``ARCHS[n].smoke().replace(dtype="bfloat16")`` within 4e-2 of
  max(1, max |logit|): bf16 rounding through two layers of each family,
  the tolerance of ``tests/test_kernels.py`` for bf16. The reference runs
  op by op (``jax.disable_jit``), as eager torch does: under ``jit`` XLA
  fuses elementwise chains and skips bf16 roundings between their ops, which
  moves its own zamba2 logits by 3.5e-2 (rel) against its op-by-op run. The stub frontends'
  inputs are handed to both packages as one NumPy array, and the port's
  MoE layers replay the reference's dispatch plans (a choice near a tie
  turns on the last bits, which XLA's bf16 and torch's round differently;
  ``tests/test_torch_moe.py`` holds the routing itself in f32).
- At zamba2's full depth (54 layers; smoke width) two correct attention
  paths move its bf16 logits apart by more than that tolerance, in the
  reference (its Pallas kernel against its plain attention) and in the
  port (its plain attention against torch's own), while in f32 from the
  same weights each pair agrees within 1e-3: why the GPU smoke test holds
  zamba2's kernel path in f32.
- ``StageServer`` maps a variant index by ``z % len(variants)`` while the
  pipeline orders a task's variants arch-major over quants, so a quant
  index selects another arch in a live run: the reference's behaviour,
  pinned here for both packages.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_families import carry  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models.convert import _as_tensor as convert_tensor  # noqa: E402

BF16_TOL = 4e-2
HORIZON = 30
# the wall-clock keys, and the spec, whose ``real`` flag differs by design
WALL_KEYS = ("decide_wall_s", "serve_wall_s", "decision_times", "decision_time_total",
             "experiment")
jmoe = importlib.import_module("repro.nn.moe")
tmoe = importlib.import_module("repro_torch.nn.moe")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so that parallel test workers do not contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec(ns, *, real=True):
    return ns.ExperimentSpec(
        pipeline=ns.get_pipeline("paper-4stage"),
        scenario=ns.replace(ns.get_scenario("bursty"), seed=3, horizon=HORIZON),
        controller=ns.replace(ns.get_controller("random"), seed=2),
        backend="runtime", real=real)


def virtual(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in WALL_KEYS}


def test_live_bf16_serve_equals_virtual_time_runs():
    sess = api.Session(spec(api), device="cpu", smoke=True, dtype="bfloat16")
    executed = []
    servers = sess.stage_servers()
    for i, server in enumerate(servers):
        assert all(c.dtype == "bfloat16" and c.n_layers == 2 for c in server.variants)
        assert all(m.embed.e.dtype == torch.bfloat16 for m in server.params)

        def recorded(z, tokens, i=i, execute=server.execute):
            out = execute(z, tokens)
            assert out.dtype == np.int32 and out.shape[0] == tokens.shape[0]
            executed.append((i, int(z) % 2))
            return out
        server.execute = recorded
    real = sess.serve()
    port_virtual = api.Session(spec(api, real=False)).serve()
    ref_virtual = japi.Session(spec(japi, real=False)).serve()
    assert virtual(real) == virtual(port_virtual) == virtual(ref_virtual)
    assert real["experiment"] == {**ref_virtual["experiment"], "real": True}
    s = real["summary"]
    assert s["served"] == s["submitted"] > 0
    assert set(executed) == {(i, z) for i in range(4) for z in (0, 1)}


def routed_as_the_reference(monkeypatch, jforward):
    """Run ``jforward()`` eagerly (``jax.disable_jit``: the layer scan runs
    step by step) recording the reference's MoE dispatch plans, and make
    the port's MoE layers replay them in the same order: a routing choice
    near a tie turns on the last bits of the hidden state, which XLA's bf16
    and eager torch's round differently. -> (the reference's output, a
    check that every plan was replayed)."""
    plans = []
    jroute, troute = jmoe._route, tmoe._route

    def recording(*args, **kw):
        plan = jroute(*args, **kw)
        plans.append(plan)
        return plan

    monkeypatch.setattr(jmoe, "_route", recording)
    with jax.disable_jit():
        out = jforward()
    monkeypatch.setattr(jmoe, "_route", jroute)
    replay = iter(plans)

    def replayed(*args, **kw):
        own = troute(*args, **kw)
        ref = next(replay)
        return tuple(convert_tensor(r).to(o.dtype) if isinstance(o, torch.Tensor) else r
                     for r, o in zip(ref, own, strict=True))

    monkeypatch.setattr(tmoe, "_route", replayed)
    return out, lambda: next(replay, None) is None and len(plans) > 0


@pytest.mark.parametrize("stage", range(4))
def test_stage_logits_match_reference_in_bf16(stage, monkeypatch):
    names = japi.get_pipeline("paper-4stage").stages[stage]
    ref = jengine.StageServer(f"stage{stage}",
                              [JARCHS[n].smoke().replace(dtype="bfloat16") for n in names],
                              seq_len=32, seed=stage)
    port = api.build_servers(spec(api), device="cpu", smoke=True, dtype="bfloat16")[stage]
    assert [c.name for c in port.variants] == list(names)
    rng = np.random.default_rng(20 + stage)
    for z, (jcfg, tcfg) in enumerate(zip(ref.variants, port.variants, strict=True)):
        assert (tcfg.dtype, tcfg.n_layers, tcfg.d_model) == (jcfg.dtype, jcfg.n_layers,
                                                             jcfg.d_model)
        assert tcfg.dtype == "bfloat16"
        carry(port.params[z], ref.params[z])
        tokens = rng.integers(0, 50_000, (4, 32)).astype(np.int32)
        jbatch = ref._make_batch(tokens, jcfg)
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}

        def jforward(z=z, jcfg=jcfg, jbatch=jbatch):
            return jmodels.forward(ref.params[z], jbatch, jcfg)[0]

        if tcfg.n_experts:
            want, all_replayed = routed_as_the_reference(monkeypatch, jforward)
        else:
            with jax.disable_jit():
                want = jforward()
            all_replayed = lambda: True  # noqa: E731
        want = np.asarray(want, np.float32)
        with torch.inference_mode():
            got = models.forward(port.params[z], tbatch, tcfg)[0]
        monkeypatch.setattr(tmoe, "_route", tmoe._route)
        assert all_replayed()
        assert got.dtype == torch.bfloat16 and np.isfinite(want).all()
        err = np.abs(got.float().numpy() - want).max() / max(1.0, np.abs(want).max())
        assert err < BF16_TOL, (tcfg.name, err)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_zamba2_at_depth_in_bf16_parts_two_correct_attention_paths(monkeypatch):
    """zamba2 at its full depth (54 layers, the shared block applied 9
    times) and smoke width: in bf16 the reference's Pallas flash kernel
    (interpret mode) and its plain attention move the logits apart by more
    than BF16_TOL, and so do the port's plain attention and torch's
    ``scaled_dot_product_attention`` on the reference's weights; in f32,
    from the same bf16 weights, each pair agrees within 1e-3."""
    depth = dict(n_layers=54, attn_every=6, dtype="bfloat16", use_flash=True)
    jcfg = JARCHS["zamba2-2.7b"].smoke().replace(**depth)
    tcfg = ARCHS["zamba2-2.7b"].smoke().replace(**depth)
    jp = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 32)).astype(np.int32)

    def reference(params, dtype, flash):
        cfg = jcfg.replace(dtype=dtype, use_flash=flash)
        step = jax.jit(lambda p, t: jmodels.forward(p, {"tokens": t}, cfg)[0])
        return step(params, jnp.asarray(tokens))

    plain = ops.flash_attention

    def library(q, k, v, *, causal=True, window=None):
        assert window is None
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), is_causal=causal)
        return out.transpose(1, 2)

    port = carry(models.init_model(0, tcfg, device="cpu"), jp)

    def ported(cfg, attention):
        monkeypatch.setattr(ops, "flash_attention", attention)
        with torch.inference_mode():
            return models.forward(port, {"tokens": torch.from_numpy(tokens)}, cfg)[0].float()

    parted = {"reference": rel_err(reference(jp, "bfloat16", True),
                                   reference(jp, "bfloat16", False)),
              "port": rel_err(ported(tcfg, library), ported(tcfg, plain))}
    wide = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    port.float()
    f32 = tcfg.replace(dtype="float32")
    agreed = {"reference": rel_err(reference(wide, "float32", True),
                                   reference(wide, "float32", False)),
              "port": rel_err(ported(f32, library), ported(f32, plain))}
    assert min(parted.values()) > BF16_TOL and max(agreed.values()) < 1e-3, (parted, agreed)


def test_variant_index_aliases_across_quants_as_in_the_reference():
    """paper-4stage's tasks hold 2 archs x 3 quants, arch-major; a live
    stage holds the 2 archs, so z = 1 (arch 0 at int8) runs arch 1."""
    pipe = api.get_pipeline("paper-4stage").build()
    jpipe = japi.get_pipeline("paper-4stage").build()
    names = api.get_pipeline("paper-4stage").stages[0]
    port = api.build_servers(spec(api), device="cpu", smoke=True, dtype="bfloat16")[0]
    ref = jengine.StageServer("stage0", [JARCHS[n].smoke() for n in names], seed=0)
    task, jtask = pipe.tasks[0], jpipe.tasks[0]
    assert [v.name for v in task.variants] == [v.name for v in jtask.variants] == [
        f"{n}:{q}" for n in names for q in ("bf16", "int8", "int4")]
    aliased = []
    for z, variant in enumerate(task.variants):
        port.configure(z=z)
        ref.configure(z=z)
        assert port.z == ref.z == z % len(names)
        aliased.append(variant.name.split(":")[0] != port.cfg.name)
    assert aliased == [False, True, False, False, True, False]
    tokens = np.arange(64, dtype=np.int32).reshape(2, 32)
    assert np.array_equal(port.execute(1, tokens), port.execute(3, tokens))
    assert np.array_equal(np.asarray(ref.execute(1, jnp.asarray(tokens))),
                          np.asarray(ref.execute(3, jnp.asarray(tokens))))
    assert jax.devices()[0].platform == "cpu"
