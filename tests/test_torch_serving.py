"""Port serving engine vs the JAX reference on the CPU.

``StageServer.execute`` must return the reference's tokens exactly once the
JAX weights are carried across (argmax of f32 logits that agree within
1e-4, with the first maximal index on both sides). The batchers, the
synthetic prompts and ``Config`` are NumPy and must match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core.mdp import Config as JConfig  # noqa: E402
from repro.data import synthetic_requests as j_requests  # noqa: E402
from repro.serving import PipelineServer as JPipelineServer  # noqa: E402
from repro.serving import StageServer as JStageServer  # noqa: E402
from repro.serving import batcher as jbatcher  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.mdp import Config  # noqa: E402
from repro_torch.data import synthetic_requests  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.serving import PipelineServer, StageServer, batcher  # noqa: E402

NAMES = ["llama3.2-1b", "starcoder2-3b"]


def carried_stage(jstage, name, *, seed, **kw):
    stage = StageServer(name, [ARCHS[n].smoke() for n in NAMES], seed=seed,
                        device="cpu", **kw)
    for model, jp in zip(stage.params, jstage.params):
        load_jax_params(model, jax.tree.map(np.asarray, jp))
    return stage


@pytest.fixture(scope="module")
def stages():
    jstage = JStageServer("s1", [JARCHS[n].smoke() for n in NAMES], seed=1)
    return jstage, carried_stage(jstage, "s1", seed=1)


@pytest.mark.parametrize("z", [0, 1, 3])
def test_execute_tokens_identical(stages, z):
    jstage, stage = stages
    toks = np.stack([r.tokens for r in j_requests(3, vocab=1000, seq_len=32, seed=z)])
    want = jstage.execute(z, toks)
    got = stage.execute(z, toks)
    assert got.dtype == np.int32 and got.shape == want.shape == (3, 32)
    assert np.array_equal(got, want)


def test_pipeline_flow_reconfigure_and_switch_count_match_reference(stages):
    """The same submit / process / apply_config sequence on both engines:
    identical results, stage state and switch counts."""
    jstage, _ = stages
    j0 = JStageServer("s0", [JARCHS[n].smoke() for n in NAMES], seed=0)
    jserver = JPipelineServer([j0, jstage])
    server = PipelineServer([carried_stage(j0, "s0", seed=0),
                             carried_stage(jstage, "s1", seed=1)])
    actions = [Config(z=(0, 0), f=(1, 1), b=(4, 4)), Config(z=(1, 0), f=(2, 1), b=(2, 8)),
               Config(z=(1, 3), f=(1, 1), b=(3, 1))]
    for step, cfg in enumerate(actions):
        jserver.apply_config(JConfig(z=cfg.z, f=cfg.f, b=cfg.b))
        server.apply_config(cfg)
        for r in j_requests(5, vocab=400, seq_len=32, seed=step):
            jserver.submit(r)
        for r in synthetic_requests(5, vocab=400, seq_len=32, seed=step):
            server.submit(r)
        jdone, done = jserver.process(), server.process()
        assert len(done) == len(jdone) == 5 * (step + 1)
        for a, b in zip(jdone, done):
            assert a.rid == b.rid and len(b.stage_outputs) == 2
            assert np.array_equal(a.result, b.result)
        assert server.switch_count == jserver.switch_count
        for js, ts in zip(jserver.stages, server.stages):
            assert (ts.z, ts.batcher.batch_size, ts.replicas, ts.served) == \
                (js.z, js.batcher.batch_size, js.replicas, js.served)
    assert server.switch_count == 2


def test_requests_flow_through_all_stages():
    server = PipelineServer([
        StageServer("s0", [ARCHS["starcoder2-3b"].smoke()], seed=0, device="cpu"),
        StageServer("s1", [ARCHS["llama3.2-1b"].smoke()], seed=1, device="cpu")])
    for r in synthetic_requests(7, vocab=256, seq_len=32, seed=0):
        server.submit(r)
    done = server.process()
    assert len(done) == 7
    for req in done:
        assert len(req.stage_outputs) == 2 and req.result.shape == (32,)
        assert req.tokens.dtype == np.int32


def test_stage_cfg_and_configure():
    stage = StageServer("s", [ARCHS[n].smoke() for n in NAMES], batch_size=2, device="cpu")
    assert stage.cfg.name == "llama3.2-1b"
    stage.configure(z=3, batch_size=5, replicas=2)
    assert (stage.z, stage.cfg.name, stage.batcher.batch_size, stage.replicas) == \
        (1, "starcoder2-3b", 5, 2)


def test_synthetic_requests_bit_identical():
    for kw in (dict(), dict(vocab=50_000, seq_len=17, seed=4)):
        a, b = j_requests(6, **kw), synthetic_requests(6, **kw)
        assert [r.rid for r in a] == [r.rid for r in b]
        for x, y in zip(a, b):
            assert x.tokens.dtype == y.tokens.dtype and np.array_equal(x.tokens, y.tokens)


def test_stack_tokens_bit_identical():
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 99, size=n).astype(np.int32)) for i, n in enumerate([3, 8, 12])]
    want = jbatcher.stack_tokens([jbatcher.Request(i, t) for i, t in reqs], 8)
    got = batcher.stack_tokens([batcher.Request(i, t) for i, t in reqs], 8)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_batcher_dispatch_sequence_bit_identical():
    jb, tb = jbatcher.Batcher(3, 6), batcher.Batcher(3, 6)
    for i in range(7):
        toks = np.arange(i, i + 4 + i % 3, dtype=np.int32)
        jb.put(jbatcher.Request(i, toks))
        tb.put(batcher.Request(i, toks))
    tb.batch_size = jb.batch_size = 2
    while True:
        a, b = jb.next_batch(), tb.next_batch()
        if a is None:
            assert b is None
            break
        assert [r.rid for r in a[0]] == [r.rid for r in b[0]]
        assert np.array_equal(a[1], b[1]) and len(jb) == len(tb)


def test_continuous_batcher_matches_reference():
    jc = jbatcher.ContinuousBatcher(3, max_wait=0.05)
    tc = batcher.ContinuousBatcher(3, max_wait=0.05)
    assert tc.deadline() is None and not tc.ready(0.0)
    times = [0.0, 0.01, 0.02, 0.03, 0.09, 0.2]
    for i, now in enumerate(times):
        jc.put(jbatcher.Request(i, np.zeros(2, np.int32)), now)
        tc.put(batcher.Request(i, np.zeros(2, np.int32)), now)
        assert (tc.ready(now), tc.deadline(), len(tc)) == (jc.ready(now), jc.deadline(), len(jc))
        if tc.ready(now):
            assert [r.rid for r in tc.pop(now)] == [r.rid for r in jc.pop(now)]


def test_request_latency():
    r = batcher.Request(0, np.zeros(2, np.int32), arrival=1.5)
    assert r.latency is None
    r.finish = 2.0
    assert r.latency == jbatcher.Request(0, r.tokens, arrival=1.5, finish=2.0).latency == 0.5


def test_config_as_array_matches_reference():
    c = Config(z=(1, 0, 2), f=(2, 1, 1), b=(4, 8, 16))
    want = JConfig(z=c.z, f=c.f, b=c.b).as_array()
    assert c.as_array().dtype == want.dtype and np.array_equal(c.as_array(), want)
