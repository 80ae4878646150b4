"""The port's placement rules (``repro_torch.distributed.sharding``) against
the reference's ``repro.distributed.sharding`` on the 16 x 16 abstract mesh
of ``repro.compat.abstract_mesh``, for every arch of ``ARCHS`` at its
published width.

Tensor by tensor, the port's entries equal the reference's
``PartitionSpec`` entries once the reference's stacked-layer dims (its
``_scan_prefix``: ``layers/`` one, zamba's ``mamba_layers/`` two) are
dropped and the names are mapped as ``models.convert.load_jax_params`` maps
them (``layers.3.attn.wq.w`` <-> ``layers/attn/wq/w``): params for each kind
(train, prefill, decode), the ZeRO-1 AdamW moments, the batch of every
input shape and the cache of every decode shape. Per-device bytes follow
from the entries and equal the reference's ``shard_shape``. On the card's
(1, 1) mesh every placement is whole, and ``place`` puts a model, cache and
batch on the mesh's device.
"""
import math

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh, make_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402

JMESH = compat.abstract_mesh((16, 16), ("data", "model"))
MESH = make_mesh((16, 16), ("data", "model"), device="meta")
KINDS = ("train", "prefill", "decode")
DECODE_SHAPES = [n for n, s in INPUT_SHAPES.items() if s.kind == "decode"]


def _entries(spec, nd: int) -> tuple:
    """A PartitionSpec's entries padded with None to the leaf's rank (P()
    is whole on every dim)."""
    e = tuple(spec)
    return e + (None,) * (nd - len(e))


def _ref_leaves(shardings, shapes) -> dict:
    """Reference path -> (entries, shape) of a sharding pytree."""
    return {jshd._path_str(p): (_entries(s.spec, len(leaf.shape)), tuple(leaf.shape), s)
            for (p, s), leaf in zip(jax.tree_util.tree_leaves_with_path(shardings),
                                    jax.tree_util.tree_leaves(shapes), strict=True)}


_PARAMS: dict = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = shd.abstract_params(ARCHS[arch])
    return _PARAMS[arch]


def _held(cfg, port: dict, ref: dict, params: dict):
    """Every port tensor's entries equal its reference leaf's without the
    stacked dims, and every reference leaf is some port tensor's."""
    covered = set()
    for name, spec in port.items():
        path, pre = shd.reference_path(cfg, name)
        entries, shape, sharding = ref[path]
        assert entries[:pre] == (None,) * pre, (name, entries)
        assert spec == entries[pre:], (name, path, spec, entries)
        assert tuple(params[name].shape) == shape[pre:], (name, shape)
        covered.add(path)
        # per-device bytes: the rule's shard against the reference's
        want = math.prod(sharding.shard_shape(shape)[pre:]) * params[name].element_size()
        assert shd.shard_bytes(params[name], spec, MESH) == want, name
    assert covered == set(ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_entries_equal_reference(arch, kind):
    cfg = ARCHS[arch]
    shapes = jax.eval_shape(lambda k: japi.init_model(k, JARCHS[arch]), jax.random.PRNGKey(0))
    ref = _ref_leaves(jshd.param_shardings(JARCHS[arch], JMESH, kind=kind), shapes)
    port = shd.param_shardings(cfg, MESH, kind=kind, params=_params(arch))
    _held(cfg, port, ref, _params(arch))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_opt_entries_equal_reference(arch):
    """ZeRO-1: the moments' entries add the data axis where the reference's
    do (on the layer-local dims)."""
    cfg = ARCHS[arch]
    shapes = jax.eval_shape(lambda k: japi.init_model(k, JARCHS[arch]), jax.random.PRNGKey(0))
    ref = _ref_leaves(jshd.opt_shardings(JARCHS[arch], JMESH), shapes)
    port = shd.opt_shardings(cfg, MESH, params=_params(arch))
    _held(cfg, port, ref, _params(arch))
    assert any("data" in str(s) for s in port.values())


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_entries_equal_reference(arch, shape):
    cfg, shp = ARCHS[arch], INPUT_SHAPES[shape]
    ref_b = jshd.batch_shardings(JARCHS[arch], shp, JMESH)
    specs = jsteps.batch_specs(JARCHS[arch], shp)
    port_b = shd.batch_shardings(cfg, shp, MESH)
    assert set(port_b) == set(ref_b)
    for k, s in ref_b.items():
        assert port_b[k] == _entries(s.spec, len(specs[k].shape)), k
    if shp.kind != "decode":
        return
    ctx = max(jsteps.cache_context(JARCHS[arch], shp), 1)
    cshape = jax.eval_shape(lambda: japi.init_cache(JARCHS[arch], shp.global_batch, ctx))
    ref_c = _ref_leaves(jshd.cache_shardings(JARCHS[arch], shp, JMESH), cshape)
    cache = shd.abstract_cache(cfg, shp)
    port_c = shd.cache_shardings(cfg, shp, MESH, cache=cache)
    flat = {}

    def walk(specs, tree, path):
        if isinstance(specs, dict):
            for k in specs:
                walk(specs[k], tree[k], f"{path}/{k}" if path else k)
        elif isinstance(specs, list):
            for i, (s, t) in enumerate(zip(specs, tree, strict=True)):
                walk(s, t, f"{path}/{i}" if path else str(i))
        else:
            flat[path] = (specs, tuple(tree.shape))

    walk(port_c, cache, "")
    assert set(flat) == set(ref_c)
    for path, (spec, sh) in flat.items():
        entries, rsh, _ = ref_c[path]
        assert (spec, sh) == (entries, rsh), path


def test_card_mesh_places_everything_whole():
    """On (1, 1) every entry keeps its tensor whole (each device holds all
    its bytes), and ``place`` moves model, cache and batch to the mesh's
    device; a larger mesh is refused, importing built no device state."""
    mesh = make_device_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    cfg = ARCHS["granite-moe-3b-a800m"]
    params = _params("granite-moe-3b-a800m")
    for specs in (shd.param_shardings(cfg, mesh, params=params),
                  shd.opt_shardings(cfg, mesh, params=params)):
        for name, spec in specs.items():
            assert shd.shard_bytes(params[name], spec, mesh) == \
                params[name].numel() * params[name].element_size()
    shp = INPUT_SHAPES["decode_32k"]
    cache = shd.abstract_cache(cfg, shp)
    assert shd.tree_shard_bytes(cache, shd.cache_shardings(cfg, shp, mesh, cache=cache),
                                mesh) == shd.tree_shard_bytes(
        cache, shd.cache_shardings(cfg, shp, make_mesh((1, 1), device="meta"), cache=cache),
        mesh)
    small = ARCHS["llama3.2-1b"].smoke()
    model = api.init_model(0, small, device="cpu")
    cache = api.init_cache(small, 2, 8, device="cpu")
    batch = {"tokens": torch.zeros(2, 4, dtype=torch.int32)}
    model, cache, batch = shd.place(model, mesh, cache=cache, batch=batch)
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert cache["k"].device.type == "cpu" and batch["tokens"].device.type == "cpu"
    with pytest.raises(ValueError, match="one card"):
        shd.place(model, MESH)
    assert shd.replicated(mesh) == ()
