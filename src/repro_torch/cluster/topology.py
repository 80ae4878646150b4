"""Heterogeneous multi-node cluster topology and placement scheduling.

The paper's decision problem models *device resource limitations*, but a
single scalar pool (``Pipeline.w_max``) cannot express node-local
bottlenecks, device heterogeneity, or cross-node communication. This module
models the edge cell as a set of :class:`Node` s — each with its own chip
capacity, a speed factor (relative serving rate of its device class) and a
device class label — plus a deterministic placement scheduler that bin-packs
stage replicas onto nodes.

Scheduler (shared semantics with the reference's jitted ``core.vecenv``
twin, ported with ROADMAP Queue 1 item 7 — both implementations must take
identical discrete decisions):

- stages are placed in pipeline order, replicas one at a time;
- each replica goes to the **first node (declaration order) with enough
  remaining capacity**; if none fits, it is force-placed on the node with
  the most remaining capacity (ties -> lowest index) and the shortfall is
  accumulated as ``overflow`` (the placement is then infeasible, mirroring
  the scalar ``resource_usage > w_max`` penalty);
- a stage's *primary node* is the node hosting most of its replicas
  (ties -> lowest index); adjacent stages with different primary nodes pay
  ``hop_latency`` seconds of cross-node transfer per pipeline traversal.

All capacities and per-replica resources are integral chip counts in
practice, so first-fit comparisons are exact in both float64 (here) and
float32 (vecenv) — the two backends reproduce each other bit-for-bit.

A single node with speed 1.0 and zero hop latency (``trivial`` topology)
reduces exactly to the legacy scalar-pool semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache


@dataclass(frozen=True)
class Node:
    """One edge device: chip capacity, relative speed, device class."""
    name: str
    capacity: float          # chips this node contributes to the pool
    speed: float = 1.0       # service-rate factor (latency scales by 1/speed)
    device_class: str = "edge"


@dataclass(frozen=True)
class Placement:
    """Where a configuration's stage replicas landed."""
    nodes: tuple[tuple[int, ...], ...]   # per stage: node index per replica
    node_usage: tuple[float, ...]        # per node: resource units placed
    overflow: float                      # resource that found no room
    stage_speed_sum: tuple[float, ...]   # Σ node speed over a stage's replicas
    stage_min_speed: tuple[float, ...]   # slowest node hosting the stage
    primary: tuple[int, ...]             # primary node per stage
    n_hops: int                          # adjacent stages on different nodes

    @property
    def feasible(self) -> bool:
        return self.overflow <= 0.0


@dataclass(frozen=True)
class ClusterTopology:
    """A named set of nodes plus the cross-node hop penalty."""
    name: str
    nodes: tuple[Node, ...]
    hop_latency: float = 0.0             # s per adjacent-stage cross-node hop

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def total_capacity(self) -> float:
        return sum(n.capacity for n in self.nodes)

    @property
    def trivial(self) -> bool:
        """True when the topology is semantically the legacy scalar pool:
        one node, unit speed, no hop cost."""
        return (self.n_nodes == 1 and self.nodes[0].speed == 1.0
                and self.hop_latency == 0.0)

    @classmethod
    def homogeneous(cls, w_max: float, *,
                    name: str = "homogeneous") -> ClusterTopology:
        """The paper's single scalar pool as a topology."""
        return cls(name=name, nodes=(Node("edge-0", float(w_max)),))

    # ------------------------------------------------------------ placement --

    def place(self, resources: tuple[float, ...],
              replicas: tuple[int, ...]) -> Placement:
        """Deterministic first-fit of ``replicas[n]`` copies of size
        ``resources[n]`` per stage, stages in order. See module docstring
        for the exact decision rules (mirrored by ``core.vecenv``)."""
        return _place_cached(self, tuple(float(r) for r in resources),
                             tuple(int(f) for f in replicas))

    def cursor(self) -> PlacementCursor:
        return PlacementCursor(self)


@lru_cache(maxsize=1 << 16)
def _place_cached(topo: ClusterTopology, resources: tuple[float, ...],
                  replicas: tuple[int, ...]) -> Placement:
    rem = [n.capacity for n in topo.nodes]
    speeds = [n.speed for n in topo.nodes]
    K = len(rem)
    usage = [0.0] * K
    overflow = 0.0
    stage_nodes, speed_sum, min_speed, primary = [], [], [], []
    for w, f in zip(resources, replicas, strict=True):
        assigned = []
        counts = [0] * K
        for _ in range(f):
            idx = next((k for k in range(K) if rem[k] >= w), None)
            if idx is None:                      # force-place, track shortfall
                idx = max(range(K), key=lambda k: (rem[k], -k))
                take = min(w, rem[idx])
                overflow += w - take
            else:
                take = w
            rem[idx] -= take
            usage[idx] += take
            counts[idx] += 1
            assigned.append(idx)
        stage_nodes.append(tuple(assigned))
        speed_sum.append(sum(speeds[k] for k in assigned))
        min_speed.append(min((speeds[k] for k in assigned), default=1.0))
        primary.append(max(range(K), key=lambda k: (counts[k], -k)))
    n_hops = sum(1 for a, b in zip(primary, primary[1:], strict=False) if a != b)
    return Placement(nodes=tuple(stage_nodes), node_usage=tuple(usage),
                     overflow=overflow, stage_speed_sum=tuple(speed_sum),
                     stage_min_speed=tuple(min_speed), primary=tuple(primary),
                     n_hops=n_hops)


class PlacementCursor:
    """Incremental placement for budget loops (greedy / IPA / expert
    capacity-first starts): place stages one at a time, querying whether the
    next stage's replicas still fit. On a trivial topology this reduces
    exactly to the legacy scalar-budget arithmetic
    (``can_place(w, f) == (f * w <= remaining)``)."""

    def __init__(self, topo: ClusterTopology):
        self.topo = topo
        self.rem = [n.capacity for n in topo.nodes]

    @property
    def remaining(self) -> float:
        return sum(self.rem)

    def _fit(self, w: float, f: int) -> list[int] | None:
        """First-fit ``f`` replicas of size ``w`` on a copy of the current
        remainders; None when any replica fails to fit."""
        rem = list(self.rem)
        out = []
        for _ in range(f):
            idx = next((k for k in range(len(rem)) if rem[k] >= w), None)
            if idx is None:
                return None
            rem[idx] -= w
            out.append(idx)
        return out

    def can_place(self, w: float, f: int, *, reserve: float = 0.0) -> bool:
        """Can ``f`` replicas of size ``w`` be placed while leaving at least
        ``reserve`` total capacity for later stages?"""
        if f * w > self.remaining - reserve:
            return False
        return self._fit(w, f) is not None

    def place(self, w: float, f: int) -> bool:
        """Commit the first-fit assignment. When the replicas do not fit the
        capacity is still consumed (force-placed like the scheduler, clamped
        at zero) and False is returned — mirroring the legacy scalar loop,
        where an infeasible fallback stage exhausted the budget so every
        later stage saw none."""
        fit = self._fit(w, f)
        if fit is not None:
            for k in fit:
                self.rem[k] -= w
            return True
        for _ in range(f):
            idx = max(range(len(self.rem)), key=lambda k: (self.rem[k], -k))
            self.rem[idx] -= min(w, self.rem[idx])
        return False
