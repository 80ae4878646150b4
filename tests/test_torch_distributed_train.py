"""The port's sharded train step on a ("data", "model") mesh of CPU ranks
(gloo, spawned by ``distributed.launch.run_on_mesh``, one thread each) at
smoke widths in f32, against the reference's sharded step and against the
port's one-rank step.

  * the reference's ``make_train_step`` runs unchanged in a subprocess
    with 8 forced host devices, jitted with the rules' in_shardings on 2 x 4
    as ``DRYRUN_SMOKE_SCRIPT`` builds them (tests/test_distributed.py),
    for two steps on concrete arrays from a NumPy seed: llama3.2-1b's smoke
    config and that script's granite-moe config. Its weights and batch are
    carried to 8 ranks, where the port's step (2 x 4, with ``shard_h``,
    ZeRO-1 moments) runs two steps and equals it;
  * the port's sharded step against its one-rank step on (1, 4), (2, 2),
    (2, 4) and (2, 2, 2) (``parity.train``): llama3.2-1b, granite-moe (MoE plans
    replayed), starcoder2-3b (2 kv heads on 4 ranks), granite-moe with
    vocab 510 (a d-split ``lm_head``), ``-100`` labels spread unevenly over
    the data ranks, ``microbatch=2``, S = 1024 (the loss chunked), the
    100B+ layout (``parity.train(fsdp=True)``: experts split over "data"
    too, gathered by the MoE, their gradient summed by that gather's
    backward), and a ("pod", "data", "model") mesh of 2 x 2 x 2. Every
    parameter's gradient is compared one by one, then every parameter and
    both moments after each of two steps;
  * ZeRO-1: each rank's moment bytes are the rules' (``opt_shardings``)
    and the gathered moments equal the one-rank moments;
  * remat: every family's smoke config gives the same loss and gradients
    with ``remat=True`` as without, and ``step_cost`` counts a lower peak;
  * the dry run's train_4k count on a fake 2 x 4 group: its "data" bytes
    are the gradient sum and the ZeRO gathers in closed form.

Tolerances (each relative to max(1, max |one-rank or reference|)): loss
1e-5, ``grad_norm`` 1e-4, gradients 1e-5, parameters and moments 1e-4;
the remat comparison 1e-6; bytes exactly. As in tests/test_torch_train.py,
a parameter's elements where the one-rank step took a clipped gradient
within 100 eps of 0 are held within 2 lr a step instead: there AdamW's
g / (|g| + eps) maps the gradient's last bits, which a sum over ranks
rounds otherwise, to a move of up to lr. Every launch of ranks is cut at
60 s (``run_on_mesh(timeout=)``), the reference's subprocess at 120 s.

A MoE's microbatches on a mesh are every data rank's i-th chunk of its
rows, not the one-rank step's rows [i B/k, (i+1) B/k): its ``lb_loss`` is
then taken over other rows, so the ``microbatch=2`` cases are the dense
model on (2, 2) and the MoE on (1, 4), where the two agree.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import parity  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.launch import run_on_mesh  # noqa: E402
from repro_torch.launch import dryrun, step_cost  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import api, steps  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

LOSS_TOL, GN_TOL, GRAD_TOL, TOL = 1e-5, 1e-4, 1e-5, 1e-4
LIMIT_S, REF_LIMIT_S = 60, 120
LR = 3e-4                   # parity.train's learning rate
GRANITE_DRYRUN = dict(n_experts=16, top_k=2, n_heads=4, n_kv=4)   # DRYRUN_SMOKE_SCRIPT's
# (arch, config overrides, parity.train keywords) per mesh
CASES = {(1, 4): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                  ("granite-moe-3b-a800m", {"vocab": 510}, {}),
                  ("granite-moe-3b-a800m", {}, {"microbatch": 2})],
         (2, 2): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                  ("llama3.2-1b", {}, {"uneven": True}),
                  ("llama3.2-1b", {}, {"microbatch": 2}),
                  ("llama3.2-1b", {}, {"seq": 1024, "batch": 2}),
                  ("granite-moe-3b-a800m", {}, {"fsdp": True, "batch": 8})],
         (2, 4): [("llama3.2-1b", {}, {}), ("granite-moe-3b-a800m", {}, {}),
                  ("starcoder2-3b", {}, {}),
                  ("granite-moe-3b-a800m", {}, {"uneven": True})],
         (2, 2, 2): [("llama3.2-1b", {}, {"batch": 8}),
                     ("granite-moe-3b-a800m", {}, {"fsdp": True, "batch": 8})]}
FAMILIES = {"dense": "llama3.2-1b", "moe": "granite-moe-3b-a800m",
            "vlm": "llava-next-mistral-7b", "audio": "whisper-small",
            "ssm": "xlstm-125m", "hybrid": "zamba2-2.7b"}
REF_CASES = {"llama3.2-1b": ({}, (32, 8)), "granite-moe-3b-a800m": (GRANITE_DRYRUN, (64, 8))}

# the reference's sharded step on 8 forced host devices for each (arch,
# overrides) of argv[2], on the batch the test wrote to <argv[1]>/<arch>_batch.npz
REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh, use_mesh
    from repro.configs import ARCHS
    from repro.distributed import sharding as shd
    from repro.models import api, steps
    from repro.models.config import InputShape
    from repro.train import adamw_init

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    mesh = make_mesh((2, 4), ("data", "model"))
    for arch, over in eval(sys.argv[2]):
        cfg = ARCHS[arch].smoke().replace(**over)
        batch = dict(np.load(os.path.join(sys.argv[1], arch + "_batch.npz")))
        B, S = batch["labels"].shape
        shape = InputShape("t", S, B, "train")
        params = api.init_model(jax.random.PRNGKey(0), cfg)
        opt = adamw_init(params)
        zsh = shd.opt_shardings(cfg, mesh)
        in_sh = (shd.param_shardings(cfg, mesh),
                 {"m": zsh, "v": zsh, "step": NamedSharding(mesh, P())},
                 shd.batch_shardings(cfg, shape, mesh))
        out = {"init/" + k: v for k, v in flat(params).items()}
        with use_mesh(mesh):
            step = jax.jit(steps.make_train_step(cfg), in_shardings=in_sh)
            for i in range(2):
                params, opt, met = step(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, opt),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
                out[f"loss/{i}"] = np.float64(met["loss"])
                out[f"grad_norm/{i}"] = np.float64(met["grad_norm"])
                for tag, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
                    out.update({f"{tag}{i}/{k}": v for k, v in flat(tree).items()})
        np.savez(os.path.join(sys.argv[1], arch + ".npz"), **out)
""")


def _nest(flat: dict, prefix: str) -> dict:
    """The reference pytree under ``prefix`` from its "/"-joined leaf paths
    (a node whose keys are all list indices is the list it was)."""
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _port(cfg, tree: dict) -> dict:
    """A reference pytree of the model's structure -> the port's tensors by name."""
    model = load_jax_params(api.init_model(0, cfg, device="cpu"), tree)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def run_reference(out, cases: dict) -> dict:
    """``REF_SCRIPT`` in a subprocess for ``cases`` (arch -> (config
    overrides, (text tokens a row, rows))), on ``parity.numpy_lm_batch``'s
    batch from seed 1, written to ``out`` first -> per arch the paths of the
    carried weights and batch and of its results, as ``parity.train`` reads
    them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for arch, (over, (S, B)) in cases.items():
        np.savez(out / f"{arch}_batch.npz", **parity.numpy_lm_batch(
            1, ARCHS[arch].smoke().replace(**over), B, S))
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                          repr([(a, over) for a, (over, _) in cases.items()])],
                         capture_output=True, text=True, timeout=REF_LIMIT_S, cwd=root,
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    paths = {}
    for arch, (over, _) in cases.items():
        cfg = ARCHS[arch].smoke().replace(**over)
        flat = dict(np.load(out / f"{arch}.npz"))
        batch = dict(np.load(out / f"{arch}_batch.npz"))
        carried = {"params": _port(cfg, _nest(flat, "init")),
                   **{k: torch.from_numpy(v) for k, v in batch.items()}}
        want = {"metrics": [{"loss": float(flat[f"loss/{i}"]),
                             "grad_norm": float(flat[f"grad_norm/{i}"])} for i in range(2)],
                "states": [{tag: _port(cfg, _nest(flat, f"{tag}{i}"))
                            for tag in ("params", "m", "v")} for i in range(2)]}
        paths[arch] = (str(out / f"{arch}_carried.pt"), str(out / f"{arch}_want.pt"))
        torch.save(carried, paths[arch][0])
        torch.save(want, paths[arch][1])
    return paths


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded step on 8 forced host devices."""
    return run_reference(tmp_path_factory.mktemp("ref_train"), REF_CASES)


@functools.cache
def mesh_run(shape):
    return run_on_mesh(parity.trains, shape, device="cpu", args=(CASES[shape],),
                       timeout=LIMIT_S)


TRAIN_CASES = [(shape, i) for shape in CASES for i in range(len(CASES[shape]))]


def _case_id(case):
    shape, i = case
    arch, over, kw = CASES[shape][i]
    return f"{'x'.join(map(str, shape))}-{arch}" + "".join(
        f"-{k}{v}" for k, v in {**over, **kw}.items())


def _held(r: dict):
    e = r["errs"]
    assert all(e[k] <= LOSS_TOL for k in e if k.startswith("loss")), (e, r["where"])
    assert all(e[k] <= GN_TOL for k in e if k.startswith("grad_norm")), e
    assert all(e[k] <= TOL for k in e if k.startswith(("params", "m_", "v_", "moments"))), (
        e, r["where"])
    # where the one-rank step took a gradient within 100 eps of 0, AdamW maps
    # the gradient's last bits to a move of up to lr a step (PR 19's rule)
    assert all(e[k] <= 2 * LR * int(k.split("_")[1]) for k in e if k.startswith("near")), e
    assert r["finite"]


@pytest.mark.parametrize("arch", list(REF_CASES))
def test_sharded_train_matches_reference_on_8_ranks(reference, arch):
    """Two steps of the port's step on 2 x 4 ranks (shard_h, ZeRO-1) from
    the reference's weights and batch equal the reference's sharded step
    on 8 host devices: loss, grad_norm, every parameter and moment."""
    carried, want = reference[arch]
    over, (S, B) = REF_CASES[arch]
    ranks = run_on_mesh(parity.train, (2, 4), device="cpu", args=(arch,),
                        kwargs=dict(overrides=over, carried=carried, want=want,
                                    gather_moments=False), timeout=LIMIT_S)
    for r in ranks:
        assert {f"{k}_{i}" for k in ("params", "m", "v") for i in (1, 2)} <= set(r["errs"])
        _held(r)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_sharded_train_matches_one_rank(case):
    """Every parameter's gradient, then every parameter and moment after
    each of two steps, the loss and grad_norm, on every rank."""
    shape, i = case
    for r in mesh_run(shape):
        got = r[i]
        assert got["errs"]["grads"] <= GRAD_TOL, (got["errs"], got["where"])
        _held(got)
        assert got["metrics"][1]["loss"] < got["metrics"][0]["loss"]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_zero1_moments_are_the_rules_blocks(case):
    """Each rank holds the rules' bytes of parameters and of both moments
    (opt_shardings: its data axis split over the moments too), and the
    moments gathered from every rank's blocks equal the one-rank ones."""
    shape, i = case
    for r in mesh_run(shape):
        got = r[i]
        assert got["held"]["params"] == got["rule"]["params"]
        assert got["held"]["opt"] == got["rule"]["opt"]
        assert got["held"]["grads"] == got["held"]["params"]
        assert got["errs"]["moments_gathered"] <= TOL
    if len(shape) > 1 and max(shape[:-1]) > 1:                 # a data axis: ZeRO-1 splits
        arch, over, _ = CASES[shape][i]
        whole = 2 * 4 * sum(p.numel() for p in shd.abstract_params(
            ARCHS[arch].smoke().replace(**over)).values())
        assert mesh_run(shape)[0][i]["held"]["opt"] < whole / shape[-1]


def _batch(cfg, shape, seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, spec in steps.batch_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            out[k] = (torch.randn(spec.shape, generator=g) * 0.02).to(spec.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, spec.shape, generator=g, dtype=spec.dtype)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_same_function_lower_peak(family):
    """``cfg.remat`` on one rank: the loss and every gradient equal the
    step without it, and the counted peak (fake tensors, S = 256) is
    lower: each layer keeps its input alone."""
    cfg = ARCHS[FAMILIES[family]].smoke()
    shape = InputShape("t", 32, 2, "train")
    batch = _batch(cfg, shape)
    runs, peaks = {}, {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        runs[remat] = steps.make_grad_step(c)(api.init_model(0, c, device="cpu"), batch)
        with FakeTensorMode():
            big = InputShape("t", 256, 4, "train")
            fake = {k: torch.zeros(v.shape, dtype=v.dtype)
                    for k, v in steps.batch_specs(c, big).items()}
            _, cost = step_cost.measure(steps.make_grad_step(c),
                                        api.init_model(0, c, device="cpu"), fake)
        peaks[remat] = cost.peak_bytes
    (l0, _, g0), (l1, _, g1) = runs[False], runs[True]
    assert abs(float(l0) - float(l1)) <= 1e-6
    assert g0.keys() == g1.keys()
    for k in g0:
        assert parity.rel_err(g1[k], g0[k]) <= 1e-6, k
    assert peaks[True] < peaks[False], peaks


def test_dryrun_counts_train_on_fake_8_rank_group():
    """train_4k on a fake 2 x 4 group: OK, collectives over "model" and
    "data", and the "data" bytes are the gradient sum (bf16 gradients of
    every block not split over "data") plus the ZeRO gathers of every
    parameter whose moments add "data", plus the loss's two scalars (the
    token count and the CE), each a ring all_reduce of 2(g-1)/g."""
    rec = dryrun.count("llama3.2-1b", "train_4k", smoke=True, mesh="2x4")
    assert rec["status"] == "OK" and rec["mesh"] == "2x4"
    groups = rec["roofline"]["collective"]["groups"]
    assert set(groups) == {"model", "data"}
    cfg = dryrun.arch_config("llama3.2-1b", smoke=True)
    mesh = make_mesh((2, 4), device="meta")
    params = shd.abstract_params(cfg)
    specs = shd.param_shardings(cfg, mesh, kind="train")
    zero = shd.zero_layout(cfg, mesh)
    block = {n: shd.shard_bytes(p, specs[n], mesh) for n, p in params.items()}
    n = sum(b for k, b in block.items() if "data" not in shd.split_axes(specs)[k])
    n += sum(block[k] for k in zero)
    n += 4 + 4
    assert groups["data"]["bytes_per_device"] == 2 * (2 - 1) / 2 * n
    assert rec["roofline"]["collective_s"] == pytest.approx(
        sum(g["bytes_per_device"] / g["bytes_per_s"] for g in groups.values()))
    assert rec["resident_bytes"]["opt"] == 2 * 2 * sum(block.values()) / 2
    assert rec["peak_bytes"] < dryrun.count("llama3.2-1b", "train_4k", smoke=True)["peak_bytes"]


def test_backward_collectives_are_counted():
    """Under ``counting()`` each collective's transpose counts where it runs:
    ``copy`` moves nothing forward and its gradient's all_reduce backward;
    ``psum`` the reverse; ``gather`` and ``block`` forward or backward
    (a fake group of 2 ranks, as the dry run counts)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_device_mesh
    dist = dryrun._fake_world(2)
    try:
        mesh = make_device_mesh((1, 2), device="cpu")
        x = torch.ones(4, 8, requires_grad=True)
        n = x.numel() * x.element_size()          # 2 (g - 1) / g = 1 for g = 2
        with col.use_mesh(mesh):
            for op, fwd, bwd in ((col.copy, 0, n), (col.psum, n, 0),
                                 (lambda t, a: col.gather(t, a, 1), 2 * n, 0),
                                 (lambda t, a: col.block(t, a, 1), 0, n)):
                with col.counting() as moved:
                    y = op(x, "model")
                    after_forward = moved.by_group.get(("model",), 0.0)
                    y.sum().backward()
                assert after_forward == fwd
                assert moved.by_group.get(("model",), 0.0) - after_forward == bwd
    finally:
        dist.destroy_process_group()
