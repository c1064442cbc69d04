"""Host-streaming window loaders for trajectory stores larger than the card
(port of ``sciml_pde_tpu/data/stream.py``).

The store stays in host RAM (numpy; a bf16 store, which numpy cannot hold,
as a CPU tensor), windows are gathered on the host, and a prefetch thread
with a queue of 2 gathers batch k + 1 while the card computes batch k.
The loader yields host batches and never touches the card: the trainer
copies them there (through pinned buffers), so the loader is the same on
the CPU and on the card.

Batches equal the JAX loader's bit for bit, and the device gather's
(``data/windows.py::gather_windows``) on the same rows, so a trainer's
``step.xy`` consumes them unchanged.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def _gather_np(data, idx: np.ndarray, initial_step: int, rollout: int):
    """(x, y) windows of the host store ``data`` (N, T, *spatial, C) at the
    rows ``idx`` (B, 2) of (trajectory, t0): time second-to-last, contiguous."""
    span = initial_step + rollout
    offs = np.arange(span)
    traj, frames = idx[:, 0, None], idx[:, 1, None] + offs[None, :]
    if isinstance(data, torch.Tensor):
        win = torch.movedim(data[torch.as_tensor(traj, dtype=torch.long),
                                 torch.as_tensor(frames, dtype=torch.long)], 1, -2)
        return (win[..., :initial_step, :].contiguous(),
                win[..., initial_step:, :].contiguous())
    win = np.moveaxis(data[traj, frames], 1, -2)
    return (
        np.ascontiguousarray(win[..., :initial_step, :]),
        np.ascontiguousarray(win[..., initial_step:, :]),
    )


def _host(data):
    """A host store: a CPU tensor stays one (bf16), anything else is numpy."""
    return data.cpu() if isinstance(data, torch.Tensor) else np.asarray(data)


class HostWindowLoader:
    """Iterable of ``(x, y)`` window batches gathered on the host.

    Args:
      data: ``(N, T, *spatial, C)`` host array (an ``np.memmap`` streams
        straight off disk).
      index: ``(n, 2)`` int32 (trajectory, t0) rows.
      initial_step / rollout: window split, as in ``gather_windows``.
      batch_size: fixed batch size; the remainder is dropped, and when
        fewer rows than ``batch_size`` exist they are tiled to one batch
        (the policy of ``epoch_batches``).
      shuffle: reshuffle rows each epoch.
      seed: seed of the ``np.random.default_rng`` that shuffles.
      prefetch: gather the next batch on a thread while the caller computes.
    """

    def __init__(self, data, index, initial_step: int, rollout: int,
                 batch_size: int, shuffle: bool = True, seed: int | None = None,
                 prefetch: bool = True):
        self.data = _host(data)
        self.index = np.asarray(index, np.int32)
        self.initial_step = int(initial_step)
        self.rollout = int(rollout)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.prefetch = bool(prefetch)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return max(len(self.index) // self.batch_size, 1)

    def _epoch_order(self) -> np.ndarray:
        n = len(self.index)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        if n < self.batch_size:
            reps = -(-self.batch_size // max(n, 1))
            return np.tile(order, reps)[: self.batch_size]
        return order

    def _epoch_rows(self):
        order = self._epoch_order()
        for b in range(len(self)):
            yield self.index[order[b * self.batch_size:(b + 1) * self.batch_size]]

    def _batches(self):
        for rows in self._epoch_rows():
            yield _gather_np(self.data, rows, self.initial_step, self.rollout)

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()

        def worker():
            try:
                for item in self._batches():
                    q.put(item)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()


class AuxHostWindowLoader(HostWindowLoader):
    """Host-streaming loader for aux joint training: ``(x, y, xa, ya)``
    batches, the primary windows and their paired aux windows at the same
    t0 from a second host store.  Pairing is the aux step's: ``row_map``
    ((Np, nA) int32, NS's per-file pairing) when given, else rows
    ``p * num_aux + (0 .. num_aux - 1)``, flattened p-major."""

    def __init__(self, data, aux_data, index, initial_step: int, rollout: int,
                 batch_size: int, num_aux: int, row_map=None, **kw):
        super().__init__(data, index, initial_step, rollout, batch_size, **kw)
        self.aux_data = _host(aux_data)
        self.num_aux = int(num_aux)
        self.row_map = None if row_map is None else np.asarray(row_map, np.int64)

    def _batches(self):
        for rows in self._epoch_rows():
            x, y = _gather_np(self.data, rows, self.initial_step, self.rollout)
            p, t0 = rows[:, 0], rows[:, 1]
            if self.row_map is None:
                offs = np.arange(self.num_aux)
                ap = (p[:, None] * self.num_aux + offs[None, :]).reshape(-1)
            else:
                ap = self.row_map[p].reshape(-1)
            a_rows = np.stack([ap, np.repeat(t0, self.num_aux)], axis=1).astype(np.int32)
            xa, ya = _gather_np(self.aux_data, a_rows, self.initial_step, self.rollout)
            yield x, y, xa, ya
