"""2D diffusion-reaction baseline loader (port of ``sciml_pde_tpu/data/dr.py``).

Single HDF5 file keyed by zero-padded seed groups; 90/10 train/test split
by sorted key order; ``train_subsample`` keeps the first N train keys (a
float < 1 keeps that fraction; a float >= 1 is a count, as an int is) and
raises when the split holds fewer.  The selected trajectories become device
tensors.  Not ported yet: ``extra_train_files`` and ``leaky_clip``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.io.h5 import list_seed_groups, read_seed_data, read_seed_grid

PRIMARY_FILE = "2D_diff-react_test_all.h5"


@dataclasses.dataclass
class DRBaselineDataset:
    train: WindowedTrajectories
    test: WindowedTrajectories


def _read_keys(path: Path, keys) -> np.ndarray:
    return np.stack([read_seed_data(path, k) for k in keys])


def _read_grid(path: Path, key: str) -> np.ndarray:
    g = read_seed_grid(path, key)
    gx, gy = np.meshgrid(g["x"], g["y"])  # (H, W) each; data is (H=Ny, W=Nx)
    return np.stack([gx, gy], axis=-1)


def _split_keys(keys: list[str]) -> tuple[list[str], list[str]]:
    """90/10 train/test by sorted key order."""
    n_train = int(0.9 * len(keys))
    return keys[:n_train], keys[n_train:]


def _resolve_count(train_keys: list[str], subsample) -> int:
    """Train trajectories asked for: a float below 1 is a fraction of the
    split (at least one), anything else a count (a float >= 1 truncated)."""
    if isinstance(subsample, float) and subsample < 1:
        return max(int(subsample * len(train_keys)), 1)
    return int(subsample)


def load_dr_baseline(
    base_path: str,
    *,
    train_subsample=900,
    initial_step: int = 10,
    rollout_test: int = 1,
    primary_file: str = PRIMARY_FILE,
    device=None,
) -> DRBaselineDataset:
    """Train = the first ``train_subsample`` keys of the 90% split, test =
    the 10% tail with one window at t0 = 0 per trajectory."""
    path = Path(base_path) / primary_file
    train_keys, test_keys = _split_keys(list_seed_groups(path))
    count = _resolve_count(train_keys, train_subsample)
    if len(train_keys) < count:
        raise ValueError(
            f"requested {count} train trajectories but only "
            f"{len(train_keys)} available in {primary_file}"
        )
    want = train_keys[:count]
    grid = _read_grid(path, train_keys[0] if train_keys else test_keys[0])
    return DRBaselineDataset(
        train=WindowedTrajectories(_read_keys(path, want), grid, initial_step=initial_step,
                                   rollout=rollout_test, train=True, device=device),
        test=WindowedTrajectories(_read_keys(path, test_keys), grid,
                                  initial_step=initial_step, rollout=rollout_test,
                                  train=False, device=device),
    )
