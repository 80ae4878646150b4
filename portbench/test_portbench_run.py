"""A whole run of the harness on the CPU at smoke size in float32, past its
look for a chip: a sound program comes out correct (its gaps are rounding, far
under 0.05), and each fault a serving cell can have, planted in the program
underneath the harness, comes out not correct."""

import numpy as np
import pytest

from portbench import harness, smoke

SEED = 2**31 + 91


def run(tmp_path, workload="edge4.steady120", seconds=0.0, trace=False):
    root = smoke.make_root(tmp_path, workload, limit=0.05)
    cell = harness.Cell(workload, root=root, device="cpu", log=lambda msg: None)
    window = cell.run(SEED, seconds, trace)
    checks, acc, _ = cell.judge(window)
    return harness.report(cell, window, trace, checks, acc), window


def test_sound_run_is_correct(tmp_path):
    out, window = run(tmp_path)
    assert out["correct"], out["checks"]
    segments = len(window["envs"])
    assert out["failed"] == 0 and out["attempted"] == segments * window["envs"][0].submitted
    assert list(out)[-1] == "checks" and out["device"]["platform"] == "cpu"
    assert set(out["metrics"]) == {"live_req_per_s", "service_p95_ms", "setup_s"}
    assert segments == 1 and window["rec"].batches[-1].stage == 3


def test_traced_run_reports_per_layer_metrics(tmp_path):
    out, _ = run(tmp_path, "serve3.steady240", seconds=1.0, trace=True)
    assert out["correct"], out["checks"]
    assert {"host_share", "reqs_per_batch", "execute_p95_ms", "serve_mfu"} <= set(out["metrics"])
    assert 0 <= out["metrics"]["host_share"]["value"] <= 100
    assert "breakdown" in out and "window_s" in out["device"]


def _unchanged(self, z, tokens):
    return tokens % self.variants[z].vocab


def _token_altered(orig):
    def execute(self, z, tokens):
        out = orig(self, z, tokens).copy()
        out[:, out.shape[1] // 2] = (out[:, out.shape[1] // 2] + 1) % self.variants[z].vocab
        return out
    return execute


def _half_batch(orig):
    def execute(self, z, tokens):
        half = max(1, tokens.shape[0] // 2)
        out = orig(self, z, tokens[:half])
        return out[np.arange(tokens.shape[0]) % half]
    return execute


@pytest.mark.parametrize("fault", ["unchanged", "token_altered", "half_batch"])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from repro_torch.serving.engine import StageServer

    orig = StageServer.execute
    broken = {"unchanged": _unchanged, "token_altered": _token_altered(orig),
              "half_batch": _half_batch(orig)}[fault]
    monkeypatch.setattr(StageServer, "execute", broken)
    out, _ = run(tmp_path)
    assert not out["correct"]
    gaps = [c["value"] for k, c in out["checks"].items() if k.startswith("gap.")]
    assert max(gaps) > 0.5


def test_an_altered_llava_token_is_not_correct(tmp_path, monkeypatch):
    """edge4.steady240 at its full rate, where stage 3 serves llava-next: a
    token altered where llava produces it fails llava's own check."""
    from repro_torch.serving.engine import StageServer

    orig = StageServer.execute
    broken = _token_altered(orig)

    def altered(self, z, tokens):
        return (broken if self.variants[z].family == "vlm" else orig)(self, z, tokens)

    monkeypatch.setattr(StageServer, "execute", altered)
    root = smoke.make_root(tmp_path, "edge4.steady240", limit=0.05, rate=240.0)
    cell = harness.Cell("edge4.steady240", root=root, device="cpu", log=lambda msg: None)
    checks, _, _ = cell.judge(cell.run(SEED, 0.0))
    assert checks["gap.llava-next-mistral-7b"][0] > 0.5 and not harness.passes(checks)
    assert all(v <= lim for k, (v, lim) in checks.items() if "llava" not in k), checks


@pytest.mark.parametrize("mix", ["steady_high.120", "steady_high.240"])
def test_every_seed_serves_the_same_arrivals(mix):
    from portbench import spec, traffic as gen

    traffic = spec.load_traffic(mix)
    times, tokens = gen.segment(traffic, SEED)
    again, other = gen.segment(traffic, 2**31 + 5)
    assert len(times) > 0.8 * traffic["rate"] * traffic["segment_s"]
    assert np.array_equal(times, again) and not np.array_equal(tokens, other)


# the first decision of each cell's segment, at the cell's 10 s and at the 2 s
# that calibrate.py serves: stage 3 of edge4 is (granite-3-8b, llava-next)
FIRST_DECISION = {"edge4.steady120": ((0, 0, 0, 0), (4, 32, 32, 32)),
                  "edge4.steady240": ((0, 0, 0, 1), (8, 32, 32, 32)),
                  "serve3.steady240": ((1, 0, 0), (8, 32, 32))}


@pytest.mark.parametrize("horizon", [10, 2])
@pytest.mark.parametrize("workload", sorted(FIRST_DECISION))
def test_first_decision_serves_the_variants_the_cell_names(workload, horizon):
    """The controller's first decision on the mix, made by the program's
    ``capacity`` controller over the pipeline it builds from its own
    architectures: which variant each stage serves, and its batch."""
    from repro_torch.api.session import Session
    from repro_torch.cluster.env import RuntimeEnv
    from repro_torch.core.controller import decide

    from portbench import traffic as gen

    cell = harness.Cell(workload, device="cpu")
    sess = Session(cell.spec(horizon, SEED), device="cpu", dtype=cell.config["dtype"])
    env = RuntimeEnv(sess.pipe, gen.Arrivals(cell.traffic, SEED), horizon=horizon,
                     seq_len=cell.traffic["seq_len"], vocab=cell.traffic["vocab"])
    cfg = decide(sess.build_controller(), env)
    assert (tuple(cfg.z), tuple(cfg.b)) == FIRST_DECISION[workload]
    if workload == "edge4.steady240":
        assert cell.archs(3)[cfg.z[3]]["name"] == "llava-next-mistral-7b"
