"""Where the train stores live while both trainers run (the host-streaming,
pool-rotation and sharded-store paths of ``sciml_pde_tpu/train/fno_train.py``
and ``transformer_train.py``).

  ``PinnedRing``    host batches to the device: each leaf is copied into
                    a pinned slot of a ring allocated once, then to the
                    card with ``non_blocking`` copies; a slot is refilled
                    only after the event recorded behind its copy has
                    completed
  ``InFlight``      at most ``STREAM_PIPELINE`` steps queued on the card:
                    before queueing another, wait for the step that many
                    back
  ``ResidentPool``  ``resident_rotate=R``: the pool stays in host RAM and
                    one 1/R trajectory slice is on the device, swapped
                    between epochs by ``slice_for``'s schedule; the
                    outgoing slice is released before the incoming one is
                    built, so the peak is one slice plus one chunk
  ``relay_aux``     the aux pool re-laid in pairing order, so primary rows
                    [a, b) own aux rows [a * nA, b * nA) (rotation and
                    ``shard_store`` pair by ``p * nA + j`` in slice- or
                    shard-local rows)
  ``place_stores``  all of it for one run, from the trainers' options
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from sciml_pde_torch.data.stream import AuxHostWindowLoader, HostWindowLoader
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.utils.transfer import device_put_chunked

# steps queued on the card at most under host streaming (and the
# transformer's device store), as the JAX trainers bound their dispatch
STREAM_PIPELINE = 8


class PinnedRing:
    """Host batches (tuples of numpy arrays or CPU tensors) to ``dev``.  On
    CUDA through ``slots`` pinned slots per leaf, allocated at the first
    batch (the shapes stay fixed over a run), the copy to the card
    asynchronous; on the CPU the batch is its own device copy."""

    def __init__(self, dev: torch.device, slots: int = STREAM_PIPELINE + 1):
        self.dev, self.n = dev, slots
        self.slots: list | None = None
        self.events: list = [None] * slots
        self.batches = 0
        self.bytes_moved = 0

    def __call__(self, batch) -> tuple:
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                  for a in batch]
        self.bytes_moved += sum(t.numel() * t.element_size() for t in leaves)
        self.batches += 1
        if self.dev.type != "cuda":
            return tuple(leaves)
        if self.slots is None:
            self.slots = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves]
                          for _ in range(self.n)]
        s = (self.batches - 1) % self.n
        if self.events[s] is not None:
            self.events[s].synchronize()  # the slot's last copy to the card has finished
        out = []
        for slot, t in zip(self.slots[s], leaves):
            slot.copy_(t)
            out.append(slot.to(self.dev, non_blocking=True))
        self.events[s] = torch.cuda.Event()
        self.events[s].record()
        return tuple(out)


# the last run's streaming and rotation figures (bytes of host batches to the
# device, their count, seconds of each slice swap), for the card's measurements
LAST_RUN: dict = {}


def record_run(ring: PinnedRing, pool) -> None:
    LAST_RUN.clear()
    LAST_RUN.update(bytes_to_device=ring.bytes_moved, host_batches=ring.batches,
                    swap_s=list(pool.swap_s) if pool is not None else [])


class InFlight:
    """Bounds the steps queued on the card: ``add()`` after queueing a step
    waits for the step ``depth`` back to finish.  A no-op on the CPU."""

    def __init__(self, dev: torch.device, depth: int = STREAM_PIPELINE):
        self.on = dev.type == "cuda"
        self.depth = depth
        self.q: deque = deque()

    def add(self) -> None:
        if not self.on:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.q.append(ev)
        if len(self.q) > self.depth:
            self.q.popleft().synchronize()


def slice_for(ep: int, R: int, epochs: int, schedule: str) -> int:
    """The resident slice of epoch ``ep`` (JAX's ``_slice_for``): ``cyclic``
    ep % R; ``interleave`` two half-run passes over the slices (every slice
    in both halves of a decaying learning rate); otherwise ``block``, one
    contiguous segment per slice."""
    if schedule == "cyclic":
        return ep % R
    if schedule == "interleave":
        half = max(epochs // 2, 1)
        ep_h, span = (ep, half) if ep < half else (ep - half, max(epochs - half, 1))
        return min((ep_h * R) // span, R - 1)
    return min((ep * R) // max(epochs, 1), R - 1)


def relay_aux(aux_host, row_map, n_total: int, num_aux: int):
    """The aux pool in pairing order: ``aux[row_map.reshape(-1)]`` (NS; a
    permutation that is the identity costs no copy), or its first
    ``n_total * num_aux`` rows (the DR pairing; a pool with fewer raises)."""
    if row_map is not None:
        perm = np.asarray(row_map, np.int64).reshape(-1)
        if len(perm) == len(aux_host) and np.array_equal(perm, np.arange(len(perm))):
            return aux_host
        return aux_host[torch.as_tensor(perm)] if isinstance(aux_host, torch.Tensor) \
            else aux_host[perm]
    need = n_total * num_aux
    if len(aux_host) < need:
        raise ValueError(f"aux pool has {len(aux_host)} rows; rotation needs "
                         f"n_total*num_aux_samples = {need}")
    return aux_host[:need]


class ResidentPool:
    """``resident_rotate=R`` over a primary store (and its re-laid aux
    store): ``train_w.data`` (and ``aux_w.data``) hold one 1/R slice.  Until
    the first ``load`` they hold a host view of slice 0, so window
    bookkeeping sees the slice's shape and a resumed run loads no slice it
    does not train on."""

    def __init__(self, train_w, aux_w, R: int, num_aux: int, dev: torch.device):
        n_total = train_w.num_trajectories
        if n_total % R:
            raise ValueError(f"resident_rotate={R} must divide the pool's "
                             f"{n_total} trajectories")
        self.train_w, self.aux_w, self.dev, self.R = train_w, aux_w, dev, R
        self.n_res, self.nA = n_total // R, num_aux
        self.prim_host = train_w.data
        self.aux_host = None if aux_w is None else aux_w.data
        self.current: int | None = None
        self.swap_s: list[float] = []  # seconds of each load, the copies included
        train_w.data = self.prim_host[:self.n_res]
        if aux_w is not None:
            aux_w.data = self.aux_host[:self.n_res * num_aux]

    def load(self, k: int) -> None:
        """Slice ``k`` onto the device; the outgoing slice is released first
        (after the steps that read it have finished)."""
        if k == self.current:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        self.train_w.data = None
        if self.aux_w is not None:
            self.aux_w.data = None
        r, a = self.n_res, self.n_res * self.nA
        self.train_w.data = device_put_chunked(self.prim_host[k * r:(k + 1) * r],
                                               device=self.dev)
        if self.aux_w is not None:
            self.aux_w.data = device_put_chunked(self.aux_host[k * a:(k + 1) * a],
                                                 device=self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.swap_s.append(time.perf_counter() - t0)
        self.current = k


@dataclasses.dataclass
class Placement:
    """Where a run's train stores live: ``train_w`` / ``aux_w`` (copies of
    the dataset's records, so the caller's dataset is left as it was),
    the window rows ``train_idx`` (over the whole pool when sharded), the
    aux pairing the step uses, and at most one of a host-streaming
    ``loader``, a rotating ``pool`` or a store sharded over ``shard_n_traj``
    trajectories."""
    train_w: WindowedTrajectories
    aux_w: WindowedTrajectories | None
    train_idx: np.ndarray
    row_map: np.ndarray | None
    mesh: Any
    loader: Any = None
    pool: ResidentPool | None = None
    shard_n_traj: int | None = None


def place_stores(train_w: WindowedTrajectories, aux_w: WindowedTrajectories | None, *,
                 batch_size: int, seed: int, dev, num_aux: int = 0, row_map=None,
                 host_stream: bool = False, resident_rotate: int = 0,
                 shard_store: bool = False, mesh) -> Placement:
    """The placement of both trainers (JAX's ``run_training`` between the
    loaders and the epoch loop):

      ``resident_rotate=R``  the aux pool re-laid in pairing order, then a
                             ``ResidentPool`` of R slices (the pairing
                             becomes ``p * nA + j`` in slice-local rows);
      ``shard_store``        rank r's trajectories [r N/n, (r+1) N/n) of
                             the pool (and their re-laid aux rows) on its
                             device, batches from ``sharded_epoch_batches``;
      ``host_stream``        the stores stay in host RAM and a
                             ``HostWindowLoader`` (``AuxHostWindowLoader``)
                             seeded with ``seed`` gathers the batches."""
    train_w = copy.copy(train_w)
    aux_w = None if aux_w is None else copy.copy(aux_w)
    R = int(resident_rotate or 0)
    pool = loader = shard_n = None
    if R > 1:
        if aux_w is not None:
            aux_w.data = relay_aux(aux_w.data, row_map, train_w.num_trajectories, num_aux)
            row_map = None
        pool = ResidentPool(train_w, aux_w, R, num_aux, dev)
    train_idx = train_w.window_index()
    if shard_store:
        n, n_traj = mesh.shape["data"], train_w.num_trajectories
        if n_traj % n or batch_size % n:
            raise ValueError(f"shard_store needs n_traj ({n_traj}) and batch_size "
                             f"({batch_size}) divisible by the data axis ({n})")
        per, r = n_traj // n, mesh.rank
        train_w.data = device_put_chunked(train_w.data[r * per:(r + 1) * per], device=dev)
        if aux_w is not None:
            aux = relay_aux(aux_w.data, row_map, n_traj, num_aux)
            aux_w.data = device_put_chunked(aux[r * per * num_aux:(r + 1) * per * num_aux],
                                            device=dev)
            row_map = None
        shard_n = n_traj
    if host_stream:
        win = (train_idx, train_w.initial_step, train_w.rollout, batch_size)
        loader = (HostWindowLoader(train_w.data, *win, seed=seed) if aux_w is None else
                  AuxHostWindowLoader(train_w.data, aux_w.data, *win, num_aux,
                                      row_map=row_map, seed=seed))
    return Placement(train_w, aux_w, train_idx, row_map, mesh, loader, pool, shard_n)
