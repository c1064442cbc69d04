"""The process group of a multi-process run (port of
``sciml_pde_tpu/parallel/distributed.py``).

Every process runs the same program; ``distributed_init`` joins them into
one ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU) and
``make_mesh`` then spans all its ranks:

    from sciml_pde_torch.parallel import distributed_init, make_mesh

    distributed_init()        # under torchrun: rank and world from its environment
    mesh = make_mesh()        # the 'data' axis over every rank
    batch = host_local_array(local_batch, mesh)   # each rank's rows -> the global batch

Outside ``torchrun`` pass the coordinator (``host:port`` of rank 0's TCP
store), the number of processes and this process's rank.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from sciml_pde_torch._device import resolve_device


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    device=None,
) -> None:
    """Join this process to the process group (idempotent: a second call
    returns at once).

    With no arguments the rank, world size and rendezvous come from the
    environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); otherwise the group meets at
    ``tcp://{coordinator_address}``.  On CUDA (``device``, CUDA unless the CPU
    is asked for) the backend is NCCL and the process takes the card
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else its rank modulo the
    cards; on the CPU the backend is gloo."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(local)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)


def host_local_array(local_batch, mesh, sharding=None):
    """The global batch from every rank's rows: each rank passes its
    ``local_batch`` (the same shape on every rank) and gets the
    concatenation over the mesh's ranks, in rank order (an all-gather).
    numpy in, numpy out.  Without a process group the batch is its own
    global batch.  ``sharding`` is accepted for the JAX signature; the
    batch is split over the leading axis."""
    del sharding
    is_np = not isinstance(local_batch, torch.Tensor)
    t = torch.as_tensor(np.asarray(local_batch)) if is_np else local_batch
    if mesh.shape["data"] > 1:
        if dist.get_backend() == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
        dist.all_gather(parts, t.contiguous())
        t = torch.cat(parts)
    return t.cpu().numpy() if is_np else t
