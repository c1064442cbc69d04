"""Trajectory store on the device and window batching (port of
``sciml_pde_tpu/data/windows.py``).

The whole trajectory tensor ``(N, T, *spatial, C)`` lives on the device and
windows are gathered there from ``(trajectory, t0)`` index rows, so the host
only ships small index tensors per step.  A store can instead stay in host
RAM (``to_device=False``) for the host-streaming loaders of
``data/stream.py`` and pool rotation; a store split over the ranks of a
process group (``shard_store``) samples through ``sharded_epoch_batches``
and gathers through ``sharded_gather_windows``.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_windows(data: torch.Tensor, idx: torch.Tensor, initial_step: int, rollout: int):
    """data (N, T, *spatial, C), idx (B, 2) rows of (trajectory, t0) ->
    x (B, *spatial, initial_step, C), y (B, *spatial, rollout, C): time
    second-to-last, the model-facing layout.

    Frame indices past the end of a trajectory are clamped to its last
    frame, as the JAX gather clamps them: the autoregressive step gathers
    ``t_train - initial_step`` target frames from windows indexed for a
    shorter rollout, and relies on it.  The clamp runs on the device.  Both
    halves come back contiguous, the layout the host loaders of
    ``data/stream.py`` ship, so a step computes the same bits from either."""
    span = initial_step + rollout
    offs = torch.arange(span, device=idx.device, dtype=idx.dtype)
    frames = torch.clamp(idx[:, 1, None] + offs[None, :], 0, data.shape[1] - 1)
    win = data[idx[:, 0, None], frames]
    win = torch.movedim(win, 1, -2)
    return win[..., :initial_step, :].contiguous(), win[..., initial_step:, :].contiguous()


class WindowedTrajectories:
    """A trajectory store (a device tensor) with its grid and window
    bookkeeping.  ``train=True`` enumerates every sliding window;
    ``train=False`` exposes one window per trajectory at t0 = 0.  The store
    is f32, or ``dtype`` (``torch.bfloat16`` halves a large train store;
    the steps cast gathered windows to f32 before any compute); f32 data
    converts to bf16 rounding to nearest even, as ``ml_dtypes`` does.

    The store goes to ``device`` through ``utils/transfer.py::
    device_put_chunked`` (bounded chunks through pinned staging), or with
    ``to_device=False`` stays in host RAM: a numpy array, or a CPU tensor
    where ``dtype`` is bf16 (numpy has no bf16).  The grid goes to
    ``device`` either way."""

    def __init__(self, data, grid, *, initial_step: int, rollout: int = 1,
                 train: bool = True, device=None, dtype=torch.float32,
                 to_device: bool = True):
        if to_device:
            from sciml_pde_torch.utils.transfer import device_put_chunked

            if device is None:  # a tensor stays where it is, numpy on the CPU
                device = data.device if isinstance(data, torch.Tensor) else "cpu"
            self.data = device_put_chunked(data, device=device, dtype=dtype)
        else:
            self.data = host_store(data, dtype)
        self.grid = torch.as_tensor(grid, dtype=torch.float32, device=device)
        self.initial_step = int(initial_step)
        self.rollout = int(rollout)
        self.train = bool(train)
        n_t = self.data.shape[1]
        if n_t < self.initial_step + self.rollout:
            raise ValueError(
                f"trajectories have {n_t} frames < initial_step+rollout "
                f"({self.initial_step}+{self.rollout})"
            )

    @property
    def num_trajectories(self) -> int:
        return int(self.data.shape[0])

    @property
    def windows_per_trajectory(self) -> int:
        if not self.train:
            return 1
        return self.data.shape[1] - self.initial_step - self.rollout + 1

    def window_index(self) -> np.ndarray:
        """(num_windows, 2) int32 host array of (trajectory, t0) rows."""
        n, w = self.num_trajectories, self.windows_per_trajectory
        traj = np.repeat(np.arange(n, dtype=np.int32), w)
        t0 = np.tile(np.arange(w, dtype=np.int32), n)
        return np.stack([traj, t0], axis=1)


def host_store(data, dtype=torch.float32):
    """``data`` kept in host RAM in ``dtype``: numpy for f32, a CPU tensor for
    another torch dtype."""
    if dtype == torch.float32:
        if isinstance(data, torch.Tensor):
            return data.detach().cpu().float().numpy()
        return np.asarray(data, np.float32)
    return torch.as_tensor(data).cpu().to(dtype)


def sharded_gather_windows(data: torch.Tensor, idx: torch.Tensor, initial_step: int,
                           rollout: int):
    """``gather_windows`` on one rank's shard of a store split over the ranks
    (``shard_store``): ``data`` holds this rank's trajectories and ``idx``
    is this rank's slice of a shard-major batch of ``sharded_epoch_batches``,
    whose trajectory ids are local to the shard.  Returns the rank's
    windows, what the JAX package's ``shard_map`` body gathers on one shard."""
    return gather_windows(data, idx, initial_step, rollout)


def sharded_epoch_batches(index: np.ndarray, batch_size: int, n_traj: int, n_shards: int,
                          rng=None):
    """Shuffled batches for a trajectory store split over ``n_shards``: each
    batch holds ``batch_size / n_shards`` windows from every shard's
    trajectory range, shard-major, with trajectory ids made local to the
    shard, so slice s of the batch indexes shard s alone.  Needs ``n_traj``
    and ``batch_size`` divisible by ``n_shards``.  The JAX package's sampler,
    draw for draw."""
    index = np.asarray(index)
    if n_traj % n_shards or batch_size % n_shards:
        raise ValueError(
            f"n_traj={n_traj} and batch_size={batch_size} must divide n_shards={n_shards}"
        )
    per_shard_traj = n_traj // n_shards
    per_shard_b = batch_size // n_shards
    shard_of = index[:, 0] // per_shard_traj
    pools = []
    for s in range(n_shards):
        rows = index[shard_of == s].copy()
        rows[:, 0] -= s * per_shard_traj
        pools.append(rows)
    n_batches = min(len(p) for p in pools) // per_shard_b
    orders = [(rng.permutation(len(p)) if rng is not None else np.arange(len(p)))
              for p in pools]
    for b in range(n_batches):
        yield np.concatenate([pools[s][orders[s][b * per_shard_b:(b + 1) * per_shard_b]]
                              for s in range(n_shards)], axis=0)


def epoch_batches(index: np.ndarray, batch_size: int, rng=None):
    """Shuffled fixed-size index batches for one epoch; the remainder is
    dropped.  Fewer rows than ``batch_size`` are tiled up to one batch."""
    index = np.asarray(index)
    n = len(index)
    order = rng.permutation(n) if rng is not None else np.arange(n)
    nb = n // batch_size
    if nb == 0:
        reps = -(-batch_size // max(n, 1))
        yield index[np.tile(order, reps)[:batch_size]]
        return
    for b in range(nb):
        yield index[order[b * batch_size:(b + 1) * batch_size]]


def weighted_epoch_batches(index: np.ndarray, batch_size: int, rng, weights: np.ndarray):
    """``epoch_batches`` with importance sampling, with replacement: the same
    batch shape and count, rows drawn by ``rng.choice`` with probability
    proportional to ``weights`` (the JAX package's draws, in its order)."""
    index = np.asarray(index)
    n = len(index)
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    nb = max(n // batch_size, 1)
    draws = rng.choice(n, size=nb * batch_size, replace=True, p=p)
    for b in range(nb):
        yield index[draws[b * batch_size:(b + 1) * batch_size]]


def make_aux_indices(num_aux_samples: int, row_map=None):
    """The aux steps' pairing: ``aux_indices(idx)`` maps primary window rows
    (B, 2) of (p, t0) to aux rows (B * num_aux_samples, 2), p-major, at the
    same t0: trajectory ``p * num_aux_samples + j``, or ``row_map[p, j]``
    ((Np, nA), NS's per-file pairing; copied to each device once)."""
    rm = None if row_map is None else torch.as_tensor(np.asarray(row_map), dtype=torch.long)
    on_device: dict = {}

    def aux_indices(idx: torch.Tensor) -> torch.Tensor:
        if rm is None:
            offs = torch.arange(num_aux_samples, device=idx.device, dtype=idx.dtype)
            ap = (idx[:, 0, None] * num_aux_samples + offs[None, :]).reshape(-1)
        else:
            m = on_device.setdefault(idx.device, rm.to(idx.device))
            ap = m[idx[:, 0]].reshape(-1).to(idx.dtype)
        return torch.stack([ap, idx[:, 1].repeat_interleave(num_aux_samples)], dim=1)

    return aux_indices


def check_aux_pairing(primary: WindowedTrajectories, aux: WindowedTrajectories,
                      num_aux_samples: int, row_map=None) -> None:
    """Raise ValueError unless every primary trajectory has its
    ``num_aux_samples`` aux rows in the aux store (``make_aux_indices``)."""
    if row_map is None:
        if aux.num_trajectories < primary.num_trajectories * num_aux_samples:
            raise ValueError(f"aux store has {aux.num_trajectories} trajectories < "
                             f"{primary.num_trajectories} primary x {num_aux_samples} aux "
                             "samples")
    elif np.asarray(row_map).shape != (primary.num_trajectories, num_aux_samples) \
            or int(np.max(row_map)) >= aux.num_trajectories:
        raise ValueError(f"aux_row_map {np.asarray(row_map).shape} does not map "
                         f"{primary.num_trajectories} primary rows x {num_aux_samples} aux "
                         f"samples into the aux store's {aux.num_trajectories} rows")
