"""3D NS plume (ScalarFlow-style) loader (port of ``sciml_pde_tpu/data/ns3d.py``).

Per-seed file pairs ``v_trj_seed{i}{suffix}.h5`` (``data`` (X, Y, Z, T, 3))
and ``s_trj_seed{i}{suffix}.h5`` (``data`` (T, X, Y, Z)) combine into a
4-channel ``(T, X, Y, Z, 4)`` trajectory: velocity ++ smoke.  The primary
stream is the ``_interp`` seeds outside ``test_seeds``, the aux stream the
suffix-less seeds, paired by the default ``p * num_aux_samples + j`` rule
(no row map); the test split is the ``_interp`` files of ``test_seeds``,
one window at t0 = 0 each, and only those frames are kept.  The files are
opened through ``io/h5.py::h5py_module``: h5py, or where it is missing the
port's own HDF5 subset (``io/hdf5_lite.py``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

from sciml_pde_torch.data.ns import STORE_DTYPES
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.io import h5 as h5io


@dataclasses.dataclass
class NS3DAuxDataset:
    primary_train: WindowedTrajectories
    primary_test: WindowedTrajectories
    aux_train: WindowedTrajectories | None
    # None selects the default p * num_aux + j pairing in the aux step
    aux_row_map: np.ndarray | None = None


def _read_pair(folder: Path, seed: int, suffix: str) -> np.ndarray:
    """One seed -> (T, X, Y, Z, 4)."""
    h5py = h5io.h5py_module()
    with h5py.File(folder / f"v_trj_seed{seed}{suffix}.h5", "r") as f:
        v = np.asarray(f["data"], np.float32)  # (X, Y, Z, T, 3) on disk
    with h5py.File(folder / f"s_trj_seed{seed}{suffix}.h5", "r") as f:
        s = np.asarray(f["data"], np.float32)  # (T, X, Y, Z)
    return np.concatenate([np.moveaxis(v, 3, 0), s[..., None]], axis=-1)


def _available_seeds(folder: Path, suffix: str) -> list[int]:
    pat = re.compile(rf"^v_trj_seed(\d+){re.escape(suffix)}\.h5$")
    return sorted(int(m.group(1)) for p in folder.glob("v_trj_seed*.h5")
                  if (m := pat.match(p.name)))


def unit_grid_3d(nx: int, ny: int, nz: int) -> np.ndarray:
    gx, gy, gz = np.meshgrid(
        np.linspace(0.0, 1.0, nx, dtype=np.float32),
        np.linspace(0.0, 1.0, ny, dtype=np.float32),
        np.linspace(0.0, 1.0, nz, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([gx, gy, gz], axis=-1)


def load_ns3d_test(base_path: str, *, initial_step: int = 10, rollout_test: int = 1,
                   test_seeds=range(275, 300), device=None) -> WindowedTrajectories:
    """The test split alone, for evaluation."""
    base = Path(base_path)
    test = np.stack([_read_pair(base, s, "_interp") for s in sorted(set(map(int, test_seeds)))])
    return WindowedTrajectories(test[:, : initial_step + rollout_test],
                                unit_grid_3d(*test.shape[2:5]), initial_step=initial_step,
                                rollout=rollout_test, train=False, device=device)


def load_ns3d_aux(
    base_path: str,
    aux_path: str | None = None,
    *,
    train_subsample=(900, 900, 900),
    num_aux_samples: int = 3,
    initial_step: int = 10,
    rollout_test: int = 1,
    test_seeds=range(275, 300),
    with_aux: bool = True,
    aux_store_dtype: str | None = None,
    store_dtype: str | None = None,
    device=None,
    to_device: bool = True,
) -> NS3DAuxDataset:
    """``train_subsample[1]`` primary ``_interp`` seeds (those not in
    ``test_seeds``) and ``train_subsample[2]`` aux seeds, which must hold
    ``n_primary * num_aux_samples`` trajectories.  ``with_aux=False``
    (baseline training) reads no aux seed.  ``to_device=False`` keeps the
    train stores in host RAM; the test store goes to ``device``."""
    base = Path(base_path)
    abase = Path(aux_path) if aux_path else base
    test_set = set(int(s) for s in test_seeds)
    train_pool = [s for s in _available_seeds(base, "_interp") if s not in test_set]
    n_primary = int(train_subsample[1])
    if len(train_pool) < n_primary:
        raise ValueError(f"{len(train_pool)} primary _interp seeds available < {n_primary}")
    primary = np.stack([_read_pair(base, s, "_interp") for s in train_pool[:n_primary]])
    grid = unit_grid_3d(*primary.shape[2:5])

    def train(data, dtype):
        return WindowedTrajectories(data, grid, initial_step=initial_step,
                                    rollout=rollout_test, train=True, device=device,
                                    dtype=STORE_DTYPES[dtype], to_device=to_device)

    aux = None
    if with_aux:
        aux_pool = _available_seeds(abase, "")
        n_aux = int(train_subsample[2])
        if len(aux_pool) < n_aux:
            raise ValueError(f"{len(aux_pool)} aux seeds available < {n_aux}")
        aux = np.stack([_read_pair(abase, s, "") for s in aux_pool[:n_aux]])
        need = n_primary * num_aux_samples
        if aux.shape[0] < need:
            raise ValueError(f"aux pool has {aux.shape[0]} trajectories < {n_primary} "
                             f"primary x {num_aux_samples} aux samples")
        aux = train(aux, aux_store_dtype)
    return NS3DAuxDataset(
        primary_train=train(primary, store_dtype),
        primary_test=load_ns3d_test(base_path, initial_step=initial_step,
                                    rollout_test=rollout_test, test_seeds=test_set,
                                    device=device),
        aux_train=aux,
    )
