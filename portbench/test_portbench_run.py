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


@pytest.mark.parametrize("mix", ["steady_high.120", "steady_high.240"])
def test_every_seed_serves_the_same_arrivals(mix):
    from portbench import spec, traffic as gen

    traffic = spec.load_traffic(mix)
    times, tokens = gen.segment(traffic, SEED)
    again, other = gen.segment(traffic, 2**31 + 5)
    assert len(times) > 0.8 * traffic["rate"] * traffic["segment_s"]
    assert np.array_equal(times, again) and not np.array_equal(tokens, other)
