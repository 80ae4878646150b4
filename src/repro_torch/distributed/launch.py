"""Start the ranks of a mesh and run one function on each (the sharded
program's launcher; the reference runs one process over all its devices).

    results = run_on_mesh(fn, (2, 4), device="cpu", args=(...))

``fn(mesh, *args, **kwargs)`` runs in every rank with ``mesh`` from
``launch.mesh.make_device_mesh``; its return values (picklable) come back
in rank order. ``fn`` must be a module-level function of a module that
imports neither jax nor the JAX package: the ranks are spawned processes,
which import it afresh.

Backend rule:
  * nccl when every rank has a card of its own (``device="cuda"`` and at
    least as many cards as ranks): rank r drives card r;
  * gloo on the CPU, and when ranks share a card (more ranks than cards):
    rank r drives card r mod count, and gloo reduces CUDA tensors through
    the host. Tensors stay on the card either way.
NCCL refuses two ranks on one card, hence the split.

A CPU rank runs one intra-op thread, so that 8 ranks do not fight over the
host's cores. A rank that raises fails the whole call: ``mp.spawn`` raises
in the caller, and nothing here catches it. A (1, 1) mesh spawns nothing:
``fn`` runs in the calling process on the one card's mesh.
"""
from __future__ import annotations

import socket
import time

import torch

from repro_torch.launch.mesh import make_device_mesh


def backend_for(device, n_ranks: int) -> str:
    """The process-group backend for ``n_ranks`` ranks on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int) -> torch.device:
    """The card (or the CPU) that ``rank`` drives."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, n, shape, device, backend, port, fn, args, kwargs, queue):
    import torch.distributed as dist
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    try:
        mesh = make_device_mesh(shape, device=dev)
        queue.put((rank, fn(mesh, *args, **kwargs)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn, shape, *, device="cuda", args=(), kwargs=None,
                timeout: float | None = None) -> list:
    """``fn(mesh, *args, **kwargs)`` on every rank of a ``shape`` mesh -> the ranks'
    results in rank order (see the module docstring). With ``timeout``
    (seconds), ranks still running then are killed and TimeoutError is
    raised: a collective that one rank never joins hangs the others."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n == 1:
        return [fn(make_device_mesh(shape, device=device), *args, **(kwargs or {}))]
    import torch.multiprocessing as mp
    queue = mp.get_context("spawn").SimpleQueue()
    ranks = mp.spawn(_rank_main, args=(n, shape, device, backend_for(device, n), free_port(),
                                       fn, args, kwargs or {}, queue), nprocs=n, join=False)
    results = [None] * n

    def drain():            # read while the ranks run: a full pipe would block them
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out

    deadline = None if timeout is None else time.monotonic() + timeout
    while not ranks.join(timeout=0.2):      # raises when a rank failed
        drain()
        if deadline is not None and time.monotonic() > deadline:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"ranks of the {shape} mesh still running after {timeout} s")
    drain()
    return results
