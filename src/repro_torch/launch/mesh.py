"""Device meshes for the port's placement rules and its sharded program
(the counterpart of ``repro/launch/mesh.py``). A mesh is a small object
built by a function, so importing this module never touches device state;
its device is resolved only when something is placed on it
(``distributed.sharding.place``).

The reference builds a 16 x 16 TPU v5e pod (``make_production_mesh``) and
runs one program over it. The port runs one process per mesh point (a
rank; ``distributed.launch.run_on_mesh`` starts them), each holding its
block of every tensor. ``make_device_mesh`` builds the mesh of the running
ranks: the (1, 1) mesh of one card when the world is one process, and
otherwise a ``torch.distributed.device_mesh.DeviceMesh`` over ("data",
"model") or ("pod", "data", "model") with a process group for every set
of axes, which ``distributed.collectives`` reduces over. ``make_mesh``
builds an abstract mesh of any shape, for the rules to answer per tensor
what each device of it would hold (the dry run's production meshes).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class Mesh:
    """Named axes with their sizes, over ``device``. A mesh of running
    ranks also carries this process's ``rank`` (row-major over the axes,
    "model" innermost), the ``backend`` of its groups, the ``DeviceMesh``
    and ``groups``: frozenset of axis names -> the process group of the
    ranks that share every other coordinate with this one. An abstract mesh
    (``groups`` None) only answers the rules."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device
    rank: int = 0
    backend: str | None = None
    device_mesh: object = field(default=None, compare=False, repr=False)
    groups: dict | None = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def running(self) -> bool:
        """Whether this process is one rank of a running mesh of several."""
        return self.groups is not None

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes, strict=True))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) as a tuple of this mesh's
        axes, in mesh order; names the mesh lacks are dropped."""
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axis_names if a in names)

    def span(self, axes) -> int:
        """Ranks in the group over ``axes``."""
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's index within the group over ``axes`` (row-major in
        the order ``axes`` are given, as a ``PartitionSpec`` tuple entry
        splits a dim)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, c = 0, self.coords
        for a in names:
            if a in self.shape:
                idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` (None for a group of one)."""
        key = frozenset(self.axes(axes))
        if not key or self.groups is None:
            return None
        return self.groups[key]


def make_mesh(shape=(1, 1), axes=AXES, device="cuda") -> Mesh:
    """An abstract mesh of ``shape`` over ``axes`` (the reference's
    ``make_mesh``): it answers the rules and runs nothing."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return Mesh(axis_names=axes, sizes=shape, device=torch.device(device))


def _groups(dist, sizes: tuple[int, ...], axes: tuple[str, ...], rank: int) -> dict:
    """A process group for every non-empty set of axes. Every rank creates
    every group in the same order (``new_group`` is collective over the
    world) and keeps those it belongs to."""
    ranks = torch.arange(int(torch.tensor(sizes).prod())).reshape(sizes)
    out = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            rest = [d for d in range(len(axes)) if d not in sub]
            span = int(torch.tensor([sizes[d] for d in sub]).prod())
            for members in ranks.permute(*rest, *sub).reshape(-1, span).tolist():
                g = dist.new_group(members)
                if rank in members:
                    out[frozenset(axes[d] for d in sub)] = g
    return out


def make_device_mesh(shape=(1, 1), device="cuda") -> Mesh:
    """The mesh of the running ranks: ``shape`` over ("data", "model"), or
    over ("pod", "data", "model") for three sizes. With one process (no
    process group) it is the one card as a (1, 1) mesh. Otherwise the
    world's size must be the mesh's: the mesh then holds a ``DeviceMesh``,
    this rank's coordinates and a group for every set of axes."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    axes = POD_AXES if len(shape) == 3 else AXES
    mesh = make_mesh(shape, axes, device)
    if mesh.size == 1 and not (dist.is_available() and dist.is_initialized()
                               and dist.get_world_size() > 1):
        return mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a {shape} mesh needs {mesh.size} running ranks: start them with "
                         "distributed.launch.run_on_mesh")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a {shape} mesh needs {mesh.size} ranks, the world has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh
    rank = dist.get_rank()
    dtype = torch.device(device).type
    dm = DeviceMesh("cpu" if dtype == "meta" else dtype,
                    torch.arange(mesh.size).reshape(shape), mesh_dim_names=axes)
    return Mesh(axis_names=axes, sizes=shape, device=mesh.device, rank=rank,
                backend=dist.get_backend(), device_mesh=dm,
                groups=_groups(dist, shape, axes, rank))
