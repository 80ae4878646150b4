"""The port's paper-figure launchers (``repro_torch.launch.{bench,
fig7_convergence,fig45_workloads,fig6_decision_time,fig3_predictor}``) vs
the reference's ``benchmarks.*``, on the CPU at small sizes.

Every reference run writes through ``benchmarks.common.set_results_dir``
and every port run through ``bench.set_results_dir``, both pointed under
``tmp_path``; nothing is written to ``experiments/``.

Tolerances:
- fig7: the same history (the committed
  ``experiments/opd_policy_edge-hetero-3.pkl``'s) through both ``run``:
  payloads equal bit for bit apart from the port's ``device`` block, rows
  equal;
- fig45 ``_episode`` of ``random``, ``greedy`` and ``ipa`` on paper-4stage
  (200 s, each regime): ``cost``, ``qos`` and ``rewards`` bit for bit;
  ``opd`` with a JAX policy (``init_policy``, seed 0) carried across:
  configurations and costs bit for bit, rewards within 1e-5; the reactive
  ``capacity`` arm of ``_serving_episode`` (60 s, bursty and ramp): equal;
  the bursty ``proactive_capacity`` arm (160 s) with the reference's
  trained lstm-multi forecaster carried across: equal;
- ``forecast_draws`` on the CPU: a seed's ``cpu``, ``device`` and
  ``carried`` serves equal, the payload as saved;
- fig45 ``--cluster edge-hetero-3 --quick`` (one regime, 400 s) with the
  committed policy carried into both ``trained_opd``: payloads equal, every
  ``reward`` within 1e-5, rows equal;
- fig6: ``decision_space`` of every pipeline equal to the reference's, IPA's
  configurations over 2 decisions on P1 and P2 equal, payload keys equal;
- fig3 with the reference's trained predictor and forecasters (one epoch)
  carried across: SMAPE and pinball within 1e-4 relative, payload keys
  equal;
- the policy cache: reused, retrained for more episodes, retrained under
  ``force``; every launcher raises on ``device="cuda"`` without a card.
"""
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import benchmarks.common as jcommon  # noqa: E402
import benchmarks.fig3_predictor as jfig3  # noqa: E402
import benchmarks.fig45_workloads as jfig45  # noqa: E402
import benchmarks.fig6_decision_time as jfig6  # noqa: E402
import benchmarks.fig7_convergence as jfig7  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.cluster import PipelineEnv as JPipelineEnv  # noqa: E402
from repro.cluster import make_trace as jmake_trace  # noqa: E402
from repro.core import IPAPolicy as JIPAPolicy  # noqa: E402
from repro.core import forecast as jforecast  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.cluster import PipelineEnv, make_trace  # noqa: E402
from repro_torch.core import IPAPolicy, forecast, policy, predictor  # noqa: E402
from repro_torch.launch import bench  # noqa: E402
from repro_torch.launch import fig3_predictor as fig3  # noqa: E402
from repro_torch.launch import fig6_decision_time as fig6  # noqa: E402
from repro_torch.launch import fig7_convergence as fig7  # noqa: E402
from repro_torch.launch import fig45_workloads as fig45  # noqa: E402
from repro_torch.launch import forecast_draws  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "experiments" / "opd_policy_edge-hetero-3.pkl"
REWARD_TOL, SMAPE_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The networks are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def out_dirs(tmp_path, monkeypatch):
    """Both packages' results dirs under ``tmp_path``: (reference, port)."""
    ref, ours = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(jcommon, "_OUT_DIR", None)
    monkeypatch.setattr(bench, "_OUT_DIR", None)
    jcommon.set_results_dir(str(ref))
    bench.set_results_dir(str(ours))
    return ref, ours


def load(path: Path, name: str) -> dict:
    return json.loads((path / f"{name}.json").read_text())


def committed_blob() -> dict:
    with open(COMMITTED, "rb") as f:
        return pickle.load(f)


def port_policy(pipe, jparams):
    state_dim = pipe.n_tasks * (9 + (0 if pipe.scalar_pool else pipe.topo.n_nodes))
    return load_jax_params(policy.Policy(state_dim, policy.head_sizes(pipe)),
                           jax.tree.map(np.asarray, jparams))


def key_tree(d):
    return {k: key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


# ------------------------------------------------------------------ fig7 --

def test_fig7_payload_and_rows_equal_the_reference(out_dirs, monkeypatch):
    hist = committed_blob()["history"]
    monkeypatch.setattr(jfig7, "trained_opd", lambda **kw: (None, hist))
    monkeypatch.setattr(fig7, "trained_opd", lambda **kw: (None, hist))
    want = jfig7.run(quick=True)
    got = fig7.run(quick=True, device="cpu")
    assert got == want
    ref, ours = (load(d, "fig7_convergence") for d in out_dirs)
    assert ours.pop("device")["name"] == "cpu"
    assert ours == ref


# ----------------------------------------------------------------- fig45 --

@pytest.mark.parametrize("kind", ["steady_low", "fluctuating", "steady_high"])
def test_fig45_episodes_equal_the_reference(kind):
    jpipe, tpipe = japi.get_pipeline("paper-4stage"), api.get_pipeline("paper-4stage")
    for name in ("random", "greedy", "ipa"):
        want = jfig45._episode(kind, name, None, jpipe, 200)
        got = fig45._episode(kind, name, None, tpipe, 200, device="cpu")
        assert len(got["cost"]) == 20
        for k in ("cost", "qos", "rewards", "configs"):
            assert got[k] == want[k], (name, k)
    built = jpipe.build()
    sizes = jpolicy.head_sizes(built)
    jparams = jpolicy.init_policy(jax.random.PRNGKey(0), built.n_tasks * 9, sizes)
    want = jfig45._episode(kind, "opd", jparams, jpipe, 200)
    got = fig45._episode(kind, "opd", port_policy(tpipe.build(), jparams), tpipe, 200,
                         device="cpu")
    assert got["configs"] == want["configs"]
    assert got["cost"] == want["cost"]
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0, atol=REWARD_TOL)


@pytest.mark.parametrize("kind", ["bursty", "ramp"])
def test_fig45_reactive_capacity_arm_equals_the_reference(kind):
    want = jfig45._serving_episode(kind, "capacity", None, japi.get_pipeline("paper-4stage"),
                                   horizon=60, predictor=None)
    got = fig45._serving_episode(kind, "capacity", None, api.get_pipeline("paper-4stage"),
                                 horizon=60, predictor=None, device="cpu")
    assert got["served"] > 0
    assert got == want


def test_fig45_proactive_arm_with_carried_forecaster_equals_the_reference(monkeypatch):
    """The bursty ``proactive_capacity`` arm at the quick horizon, with the
    reference's trained lstm-multi forecaster carried into the port."""
    trained = []
    train = jforecast.train_forecaster

    def keep(traces, **kw):
        trained.append(train(traces, **kw))
        return trained[-1]

    monkeypatch.setattr(jforecast, "train_forecaster", keep)
    want = jfig45._serving_episode("bursty", "proactive-capacity", None,
                                   japi.get_pipeline("paper-4stage"), horizon=160,
                                   predictor="lstm-multi")
    (jparams, scales), = trained
    carried = load_jax_params(forecast.Forecaster(backbone="lstm", horizons=(5, 10, 20, 60)),
                              jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(forecast, "train_forecaster", lambda traces, **kw: (carried, scales))
    got = fig45._serving_episode("bursty", "proactive-capacity", None,
                                 api.get_pipeline("paper-4stage"), horizon=160,
                                 predictor="lstm-multi", device="cpu")
    assert got["prewarms"] > 0
    assert got == want


def test_forecast_draws_serves_every_arm(out_dirs, monkeypatch):
    """On the CPU all three serves of a seed train and forecast alike."""
    monkeypatch.setattr(registry, "_PREDICTORS", dict(registry._PREDICTORS))
    api.register_predictor(api.replace(api.get_predictor("lstm-multi"), name="tiny", epochs=1))
    got = forecast_draws.run(horizon=60, seeds=(3,), predictor="tiny", device="cpu")
    res = got["seeds"]["3"]
    assert res["cpu"] == res["device"] == res["carried"]
    assert res["cpu"]["served"] > 0
    saved = load(out_dirs[1], "forecast_draws_bursty_60")
    assert saved.pop("device")["name"] == "cpu"
    assert saved == json.loads(json.dumps(got))


def test_fig45_cluster_quick_sweep_equals_the_reference(out_dirs, monkeypatch):
    """The whole ``--cluster edge-hetero-3 --quick`` sweep, with the
    committed policy in both packages' ``trained_opd``."""
    blob = committed_blob()
    tpipe = api.replace(api.get_pipeline("paper-4stage"),
                        cluster=api.get_cluster("edge-hetero-3")).build()
    tparams = port_policy(tpipe, blob["params"])
    seen = {}

    def ref_trained(**kw):
        seen["ref"] = kw
        return blob["params"], blob["history"]

    def port_trained(**kw):
        seen["port"] = kw
        return tparams, blob["history"]

    monkeypatch.setattr(jfig45, "trained_opd", ref_trained)
    monkeypatch.setattr(fig45, "trained_opd", port_trained)
    want = jfig45.run(quick=True, cluster="edge-hetero-3")
    got = fig45.run(quick=True, cluster="edge-hetero-3", device="cpu")
    assert seen["port"]["episodes"] == seen["ref"]["episodes"] == 12
    assert seen["port"]["cache_tag"] == seen["ref"]["cache_tag"] == "edge-hetero-3"
    assert got == want
    ref, ours = (load(d, "fig45_workloads_edge-hetero-3") for d in out_dirs)
    assert ours.pop("device")["type"] == "cpu"
    assert list(ours) == list(ref) == ["fluctuating"]
    for name, res in ref["fluctuating"].items():
        mine = dict(ours["fluctuating"][name])
        assert abs(mine.pop("reward") - res["reward"]) <= REWARD_TOL, name
        assert mine == {k: v for k, v in res.items() if k != "reward"}, name


# ------------------------------------------------------------------ fig6 --

def test_fig6_decision_space_and_ipa_configs_equal_the_reference():
    for jspec, tspec in zip(jfig6.PIPELINES, fig6.PIPELINES, strict=True):
        jp = jspec.build()
        want = int(np.prod([len(t.variants) * jp.f_max * jp.b_max for t in jp.tasks]))
        assert fig6.decision_space(tspec.build()) == want
    for jspec, tspec in zip(jfig6.PIPELINES[:2], fig6.PIPELINES[:2], strict=True):
        jpipe, tpipe = jspec.build(), tspec.build()
        jenv = JPipelineEnv(jpipe, jmake_trace("fluctuating", seed=5, seconds=20), seed=5)
        tenv = PipelineEnv(tpipe, make_trace("fluctuating", seed=5, seconds=20), seed=5)
        jipa, tipa = JIPAPolicy(jpipe), IPAPolicy(tpipe)
        for _ in range(2):
            want, got = jipa.decide(jenv.observe()), tipa.decide(tenv.observe())
            assert (list(got.z), list(got.f), list(got.b)) == \
                (list(want.z), list(want.f), list(want.b))
            jenv.step(want)
            tenv.step(got)


def test_fig6_payload_keys_equal_the_reference(out_dirs, monkeypatch):
    monkeypatch.setattr(jfig6, "PIPELINES", jfig6.PIPELINES[:2])
    want = jfig6.run(quick=True)
    got = fig6.run(quick=True, device="cpu", pipelines=fig6.PIPELINES[:2])
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[3] for r in got] == [r[3] for r in want]
    ref, ours = (load(d, "fig6_decision_time") for d in out_dirs)
    assert ours.pop("device")["name"] == "cpu"
    assert key_tree(ours) == key_tree(ref)
    for name in ref:
        assert ours[name]["decision_space"] == ref[name]["decision_space"]
        assert ours[name]["opd_H_s"] > 0 and ours[name]["ipa_H_s"] > 0


# ------------------------------------------------------------------ fig3 --

def test_fig3_with_carried_weights_agrees_with_the_reference(out_dirs, monkeypatch):
    """The reference trains one epoch of each network; the port receives
    those weights in place of its own training, in the same order."""
    trained = []
    jtrain_pred, jtrain_fc = jfig3.train_predictor, jforecast.train_forecaster

    def ref_predictor(traces, **kw):
        p = jtrain_pred(traces, **{**kw, "epochs": 1})
        trained.append(p)
        return p

    def ref_forecaster(traces, **kw):
        p, ch = jtrain_fc(traces, **{**kw, "epochs": 1})
        trained.append((p, ch, kw["backbone"]))
        return p, ch

    def port_predictor(traces, **kw):
        assert kw["device"] == torch.device("cpu")
        return load_jax_params(predictor.Predictor(),
                               jax.tree.map(np.asarray, trained.pop(0)))

    def port_forecaster(traces, **kw):
        p, ch, backbone = trained.pop(0)
        assert kw["backbone"] == backbone
        return load_jax_params(forecast.Forecaster(backbone=backbone),
                               jax.tree.map(np.asarray, p)), ch

    monkeypatch.setattr(jfig3, "train_predictor", ref_predictor)
    monkeypatch.setattr(jforecast, "train_forecaster", ref_forecaster)
    monkeypatch.setattr(fig3, "train_predictor", port_predictor)
    monkeypatch.setattr(forecast, "train_forecaster", port_forecaster)
    want = jfig3.run(quick=True)
    got = fig3.run(quick=True, device="cpu")
    assert not trained
    assert [r[:2] for r in got] == [r[:2] for r in want]
    ref, ours = (load(d, "fig3_predictor") for d in out_dirs)
    assert ours.pop("device")["name"] == "cpu"
    assert key_tree(ours) == key_tree(ref)

    def close(a, b):
        assert abs(a - b) <= SMAPE_RTOL * abs(b), (a, b)

    for kind in fig3.REGIMES:
        close(ours[kind]["smape_pct"], ref[kind]["smape_pct"])
    for backbone in fig3.BACKBONES:
        mine, theirs = ours["forecast"][backbone], ref["forecast"][backbone]
        for key in ("smape_pct", "pinball_q90"):
            for h in theirs[key]:
                close(mine[key][h], theirs[key][h])
        close(mine["smape_mean_pct"], theirs["smape_mean_pct"])


# ------------------------------------------------------------- plumbing --

def test_trained_opd_cache_round_trip(out_dirs):
    listing = sorted(os.listdir(ROOT / "experiments"))
    p1, h1 = bench.trained_opd(1, device="cpu", log=None)
    cache = Path(bench.policy_cache())
    assert cache.parent == out_dirs[1] and cache.name == "opd_policy.pt"
    stamp = cache.stat().st_mtime_ns
    p1b, h1b = bench.trained_opd(1, device="cpu", log=None)
    assert cache.stat().st_mtime_ns == stamp and h1b == h1
    for a, b in zip(p1.parameters(), p1b.parameters(), strict=True):
        assert torch.equal(a, b)
    _, h2 = bench.trained_opd(2, device="cpu", log=None)
    assert len(h2["reward"]) == 2 and h2["reward"][0] == h1["reward"][0]
    _, h1c = bench.trained_opd(1, device="cpu", log=None)       # 2 >= 1: reused
    assert h1c == h2
    _, hf = bench.trained_opd(1, device="cpu", log=None, force=True)
    assert hf == h1
    _, ht = bench.trained_opd(1, device="cpu", log=None, cache_tag="edge")
    assert (out_dirs[1] / "opd_policy_edge.pt").exists() and ht == h1
    assert sorted(os.listdir(ROOT / "experiments")) == listing


@pytest.mark.parametrize("call", [
    lambda: fig7.run(quick=True),
    lambda: fig45.run(quick=True),
    lambda: fig6.run(quick=True),
    lambda: fig3.run(quick=True),
    lambda: bench.trained_opd(1, log=None),
    lambda: forecast_draws.run(seeds=(0,)),
], ids=["fig7", "fig45", "fig6", "fig3", "trained_opd", "forecast_draws"])
def test_launchers_default_to_cuda(call, out_dirs, monkeypatch):
    """Asking for CUDA without a GPU raises through resolve_device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    assert not out_dirs[1].exists()
