"""Mesh construction, the rank launcher and the gather of partials.

Counterpart of `halo2_aggregation_tpu/parallel/mesh.py`.  A mesh here is a
`torch.distributed.device_mesh.DeviceMesh` over an initialized process
group; `run_ranks` starts one process a rank (the spawn start method, as
CUDA cannot be forked), joins them in one group through a `file://`
rendezvous in a temporary directory, and hands each rank's result back to
the caller.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def mesh_split(n: int) -> tuple:
    """(dp, mp) for n devices: the most-square split with dp >= mp (proof
    parallelism is the cheaper axis to shard), as the JAX `make_mesh`."""
    if n < 1:
        raise ValueError(f"n = {n}: expected >= 1")
    mp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return n // mp, mp


def make_mesh(n_devices: int | None = None, axes=("dp", "mp"), *, device="cuda") -> DeviceMesh:
    """2-D mesh over the initialized world: `dp` shards proof batches, `mp`
    shards MSM point lanes, split by `mesh_split`.  Every rank calls it.
    `n_devices`, if given, must be the world size (a rank cannot sit out of
    a torch mesh as a JAX device can)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: run under run_ranks or init_process_group")
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices = {n_devices}, but the world has {world} ranks")
    return init_device_mesh(device.type, mesh_split(world), mesh_dim_names=tuple(axes))


def axis(mesh: DeviceMesh, name: str) -> tuple:
    """(size, this rank's index, process group) of the mesh axis `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.shape[dim], mesh.get_local_rank(dim), mesh.get_group(dim)


def gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` stacked on a new axis 0 in the group's rank order, on
    t's device.  The route is the group's backend: under gloo the tensors
    travel as host tensors (the partials here are a few hundred bytes a
    rank), under NCCL they stay on the card."""
    src = t.cpu() if dist.get_backend(group) == "gloo" else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _rank_main(rank, fn, world_size, cards, backend, tmp, args):
    if cards is not None:
        torch.cuda.set_device(cards[rank])
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"), world_size=world_size, rank=rank,
        device_id=torch.device("cuda", cards[rank]) if backend == "nccl" else None,
    )
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def check_cards(world_size: int) -> None:
    """Raise ValueError unless `world_size` cards are visible: an NCCL rank
    takes a card of its own (NCCL refuses two ranks on one device)."""
    n = torch.cuda.device_count()
    if world_size > n:
        raise ValueError(f"world {world_size} needs one card a rank, {n} visible")


def run_ranks(fn, world_size: int, *, device="cuda", backend: str | None = None, args=()) -> list:
    """Run `fn(*args)` on `world_size` ranks and return their results, rank 0
    first.  Each rank is a spawned process in one process group (`backend`:
    NCCL on the card, gloo on the CPU by default).  On the card an NCCL rank
    r takes card r (`check_cards` raises before any rank starts), and gloo
    ranks share the caller's card.  A CPU rank takes one thread.  `fn` and
    `args` are pickled to the ranks and each result back, so keep results to
    host objects.  A rank that raises stops the others and raises here
    (`torch.multiprocessing.ProcessRaisedException`)."""
    device = resolve_device(device)
    if world_size < 1:
        raise ValueError(f"world_size = {world_size}: expected >= 1")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    cards = None
    if device.type == "cuda":
        if backend == "gloo":
            cards = [device.index] * world_size
        else:
            check_cards(world_size)
            cards = list(range(world_size))
    with tempfile.TemporaryDirectory(prefix="h2a-ranks-") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, cards, backend, tmp, tuple(args)), nprocs=world_size, join=True
        )
        results = []
        for rank in range(world_size):
            # written by the ranks above, in this run's own directory
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
