"""2D incompressible NS baseline loader (port of ``sciml_pde_tpu/data/ns.py``).

Per-index files ``{sim_name}-{i}.h5`` hold ``velocity (B, T, X, Y, 2)`` and
``particles (B, T, X, Y, 1)``; their channels concatenate to a
``(B, T, X, Y, 3)`` store.  ``train_subsample`` is a file count, or a float
below 1 keeping ``int(B * frac)`` trajectories of file 0.  The test split
is the files of ``test_range`` with one window at t0 = 0 each, and only
those frames are kept.  ``h5py`` is imported inside the readers, so the
package imports on a host without it.  Not ported yet: the aux pairing
(``load_ns_aux``) and ``store_dtype``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from sciml_pde_torch.data.windows import WindowedTrajectories


@dataclasses.dataclass
class NSBaselineDataset:
    train: WindowedTrajectories
    test: WindowedTrajectories


def _read_ns_file(path: Path) -> np.ndarray:
    """One NS file -> (B, T, X, Y, 3) = velocity ++ particles."""
    import h5py

    with h5py.File(path, "r") as f:
        vel = np.asarray(f["velocity"], np.float32)
        par = np.asarray(f["particles"], np.float32)
    return np.concatenate([vel, par], axis=-1)


def unit_grid(nx: int, ny: int) -> np.ndarray:
    gx, gy = np.meshgrid(
        np.linspace(0.0, 1.0, nx, dtype=np.float32),
        np.linspace(0.0, 1.0, ny, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([gx, gy], axis=-1)


def _load_primary(base: Path, sim_name: str, subsample):
    """Train trajectories per ``train_subsample``: (data (N, T, X, Y, 3),
    per_file_rows), per_file_rows[f] listing the store rows of file f."""
    if isinstance(subsample, float) and subsample < 1:
        block = _read_ns_file(base / f"{sim_name}-0.h5")
        keep = max(int(subsample * block.shape[0]), 1)
        return block[:keep], [list(range(keep))]
    blocks = [_read_ns_file(base / f"{sim_name}-{i}.h5") for i in range(int(subsample))]
    per_file, start = [], 0
    for b in blocks:
        per_file.append(list(range(start, start + b.shape[0])))
        start += b.shape[0]
    return np.concatenate(blocks), per_file


def _load_test(base: Path, sim_name: str, test_range) -> np.ndarray:
    return np.concatenate([_read_ns_file(base / f"{sim_name}-{i}.h5")
                           for i in range(*test_range)])


def load_ns_baseline(
    base_path: str,
    *,
    train_subsample=1,
    initial_step: int = 10,
    rollout_test: int = 1,
    sim_name: str = "ns_incom_inhom_2d_256",
    test_range=(250, 275),
    device=None,
) -> NSBaselineDataset:
    base = Path(base_path)
    train, _ = _load_primary(base, sim_name, train_subsample)
    test = _load_test(base, sim_name, test_range)
    grid = unit_grid(train.shape[2], train.shape[3])
    return NSBaselineDataset(
        train=WindowedTrajectories(train, grid, initial_step=initial_step,
                                   rollout=rollout_test, train=True, device=device),
        test=WindowedTrajectories(test[:, : initial_step + rollout_test], grid,
                                  initial_step=initial_step, rollout=rollout_test,
                                  train=False, device=device),
    )
