"""2D incompressible NS loaders, baseline and aux (port of
``sciml_pde_tpu/data/ns.py``).

Per-index files ``{sim_name}-{i}.h5`` hold ``velocity (B, T, X, Y, 2)`` and
``particles (B, T, X, Y, 1)``; their channels concatenate to a
``(B, T, X, Y, 3)`` store.  ``train_subsample`` is a file count, or a float
below 1 keeping ``int(B * frac)`` trajectories of file 0.  The test split
is the files of ``test_range`` with one window at t0 = 0 each, and only
those frames are kept.

Aux pairing: primary file ``f`` pairs with aux files ``f * num_aux + j`` at
the same trajectory index ``b`` within the file, given to the aux step as
``aux_row_map[p_row, j] = (f * num_aux + j) * rows_per_file + b``.  An aux
store of another resolution (``if_downsample``) is upsampled to the
primary's grid on load (JAX's linear resize, ``dr.resize_linear``), or with
``aux_upsample_at_gather`` kept at its own resolution for the step to
resize.  ``store_dtype`` / ``aux_store_dtype`` ``"bf16"`` keep the train
stores in bf16 (rounded to nearest even, as ``ml_dtypes`` rounds); the
test split stays f32.  Files open through ``io/h5.py::h5py_module`` (h5py,
or the port's own HDF5 subset where h5py is not installed).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch.data.dr import resize_linear
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.io import h5 as h5io

STORE_DTYPES = {None: torch.float32, "f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class NSBaselineDataset:
    train: WindowedTrajectories
    test: WindowedTrajectories


@dataclasses.dataclass
class NSAuxDataset:
    primary_train: WindowedTrajectories
    primary_test: WindowedTrajectories
    aux_train: WindowedTrajectories
    aux_row_map: np.ndarray  # (num_primary_rows, num_aux_samples) int32


def _read_ns_file(path: Path) -> np.ndarray:
    """One NS file -> (B, T, X, Y, 3) = velocity ++ particles."""
    with h5io.h5py_module().File(path, "r") as f:
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


def load_ns_test(base_path: str, *, initial_step: int = 10, rollout_test: int = 1,
                 sim_name: str = "ns_incom_inhom_2d_256", test_range=(250, 275),
                 device=None) -> WindowedTrajectories:
    """The test split alone (the t0 = 0 window's frames of the files of
    ``test_range``), for evaluation, which reads nothing of the train pool."""
    test = _load_test(Path(base_path), sim_name, test_range)
    return WindowedTrajectories(test[:, : initial_step + rollout_test],
                                unit_grid(test.shape[2], test.shape[3]),
                                initial_step=initial_step, rollout=rollout_test,
                                train=False, device=device)


def load_ns_baseline(
    base_path: str,
    *,
    train_subsample=1,
    initial_step: int = 10,
    rollout_test: int = 1,
    sim_name: str = "ns_incom_inhom_2d_256",
    test_range=(250, 275),
    store_dtype: str | None = None,
    device=None,
    to_device: bool = True,
) -> NSBaselineDataset:
    """Train = the trajectories ``train_subsample`` selects, in
    ``store_dtype`` (with ``to_device=False`` kept in host RAM); test = the
    t0 = 0 windows of ``test_range``, f32, on ``device``."""
    base = Path(base_path)
    train, _ = _load_primary(base, sim_name, train_subsample)
    grid = unit_grid(train.shape[2], train.shape[3])
    return NSBaselineDataset(
        train=WindowedTrajectories(train, grid, initial_step=initial_step,
                                   rollout=rollout_test, train=True, device=device,
                                   dtype=STORE_DTYPES[store_dtype], to_device=to_device),
        test=load_ns_test(base_path, initial_step=initial_step, rollout_test=rollout_test,
                          sim_name=sim_name, test_range=test_range, device=device),
    )


def ns_aux_row_map(per_file: list[list[int]], num_aux_samples: int,
                   aux_rows_per_file: int) -> np.ndarray:
    """(primary rows, num_aux_samples) int32: the row of trajectory ``b`` of
    aux file ``f * num_aux_samples + j`` for primary row ``b`` of file ``f``."""
    n_rows = sum(len(rows) for rows in per_file)
    row_map = np.empty((n_rows, num_aux_samples), np.int32)
    for f, rows in enumerate(per_file):
        for b, p_row in enumerate(rows):
            for j in range(num_aux_samples):
                row_map[p_row, j] = (f * num_aux_samples + j) * aux_rows_per_file + b
    return row_map


def load_ns_aux(
    base_path: str,
    aux_path: str | None = None,
    *,
    train_subsample=(900, 900, 900),
    num_aux_samples: int = 24,
    initial_step: int = 10,
    rollout_test: int = 1,
    sim_name: str = "ns_incom_inhom_2d_256",
    aux_name: str = "ns_aux_2d_256",
    if_downsample: bool = False,
    test_range=(250, 275),
    aux_store_dtype: str | None = None,
    store_dtype: str | None = None,
    aux_upsample_at_gather: bool = False,
    device=None,
    to_device: bool = True,
) -> NSAuxDataset:
    """Aux-paired NS dataset: ``train_subsample[1]`` primary files (or a
    fraction of file 0) with ``num_aux_samples`` aux files each;
    ``train_subsample[2]`` must allow that many aux files.  Only the aux
    files the pairing reads are loaded.  A bf16 aux store is rounded before
    an upsample on load, which then runs on its f32 values and rounds again,
    as JAX resizes the bf16 array.  ``to_device=False`` keeps both train
    stores in host RAM (an upsample on load then runs on the CPU); the test
    store goes to ``device``."""
    base = Path(base_path)
    abase = Path(aux_path) if aux_path else base
    primary, per_file = _load_primary(base, sim_name, train_subsample[1])
    n_aux_files = int(train_subsample[2])
    need_files = len(per_file) * num_aux_samples
    if n_aux_files < need_files:
        raise ValueError(
            f"need {need_files} aux files ({len(per_file)} primary files x "
            f"{num_aux_samples} aux samples) but train_subsample[2]={n_aux_files}"
        )
    aux_blocks = [_read_ns_file(abase / f"{aux_name}-{i}.h5") for i in range(need_files)]
    row_map = ns_aux_row_map(per_file, num_aux_samples, aux_blocks[0].shape[0])
    aux_dt = STORE_DTYPES[aux_store_dtype]
    aux = torch.as_tensor(np.concatenate(aux_blocks),
                          device=device if to_device else "cpu").to(aux_dt)
    if not aux_upsample_at_gather and (if_downsample or aux.shape[2:4] != primary.shape[2:4]):
        aux = resize_linear(aux, {2: primary.shape[2], 3: primary.shape[3]}).to(aux_dt)

    grid = unit_grid(primary.shape[2], primary.shape[3])

    def train(data, dtype):
        return WindowedTrajectories(data, grid, initial_step=initial_step,
                                    rollout=rollout_test, train=True, device=device,
                                    dtype=dtype, to_device=to_device)

    return NSAuxDataset(
        primary_train=train(primary, STORE_DTYPES[store_dtype]),
        primary_test=load_ns_test(base_path, initial_step=initial_step,
                                  rollout_test=rollout_test, sim_name=sim_name,
                                  test_range=test_range, device=device),
        aux_train=train(aux, aux_dt),
        aux_row_map=row_map,
    )
