"""Device meshes for the port's placement rules (the counterpart of
``repro/launch/mesh.py``). A mesh is a small object built by a function, so
importing this module never touches device state; its device is resolved
only when something is placed on it (``distributed.sharding.place``).

The reference builds a 16 x 16 TPU v5e pod (``make_production_mesh``). The
port runs on one H100: ``make_device_mesh`` is the (1, 1) mesh over
("data", "model"), on which every placement is whole. ``make_mesh`` builds
any other shape for the rules to answer, per tensor, what a model axis of
size M would hold on each device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """Named axes with their sizes, over ``device`` (one device per mesh
    point; only the (1, 1) mesh has a device to run on here)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device

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


def make_mesh(shape=(1, 1), axes=AXES, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` (the reference's ``make_mesh``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return Mesh(axis_names=axes, sizes=shape, device=torch.device(device))


def make_device_mesh(device="cuda") -> Mesh:
    """The one card as a (1, 1) ("data", "model") mesh."""
    return make_mesh((1, 1), AXES, device)
