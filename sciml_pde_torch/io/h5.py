"""HDF5 seed-group schema (port of ``sciml_pde_tpu/io/h5.py``).

Diffusion-reaction layout, byte-compatible with the reference generators
and the JAX package's:
  /{seed:04d}/data          (T, Ny, Nx, C) float32, lzf
  /{seed:04d}/grid/{x,y,t}  float32, lzf

Every HDF5 file of the port is opened through ``h5py_module()``: h5py
where it is installed, else the port's own subset of the format
(``io/hdf5_lite.py``), so the simulators, loaders and exports run on a
host without h5py.  Either is imported inside the functions that use it.
The subset writes the chunked LZF datasets h5py writes for the same calls
(h5py's chunk shape, shuffle where asked, an incompressible chunk stored
raw), so a file written where h5py is missing (the card's machine has
none) is the file h5py would have written, and every file the JAX package
writes reads there bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def h5py_module():
    """h5py, or where it is not installed ``io/hdf5_lite.py``, which writes
    and reads the port's files through the same calls."""
    try:
        import h5py
    except ImportError:
        from sciml_pde_torch.io import hdf5_lite as h5py
    return h5py


def create_seed_group(f, seed: int, data: np.ndarray, x: np.ndarray, y: np.ndarray,
                      t: np.ndarray, config_yaml: str = "") -> None:
    """One seed group in the file ``f``, open for writing."""
    seed_str = str(seed).zfill(4)
    f.create_dataset(f"{seed_str}/data", data=data, dtype="float32", compression="lzf")
    for name, arr in (("x", x), ("y", y), ("t", t)):
        f.create_dataset(f"{seed_str}/grid/{name}", data=arr, dtype="float32",
                         compression="lzf")
    if config_yaml:
        f[seed_str].attrs["config"] = config_yaml


def write_seed_groups(
    path: str | Path,
    data: dict,
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    config_yaml: str = "",
    max_retries: int = 50,
) -> None:
    """Append one seed group for each ``{seed: data}`` in one session of the
    file; an ``OSError`` (a concurrent writer holding the file) is retried
    every 0.1 s, ``max_retries`` times."""
    import time

    h5py = h5py_module()
    for attempt in range(max_retries):
        try:
            with h5py.File(path, "a") as f:
                for seed, arr in data.items():
                    create_seed_group(f, seed, arr, x, y, t, config_yaml)
            return
        except OSError:
            if attempt == max_retries - 1:
                raise
            time.sleep(0.1)


def write_seed_group(
    path: str | Path,
    seed: int,
    data: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    config_yaml: str = "",
    max_retries: int = 50,
) -> None:
    """Append one seed group (``write_seed_groups`` of one)."""
    write_seed_groups(path, {seed: data}, x, y, t, config_yaml, max_retries)


def list_seed_groups(path: str | Path) -> list[str]:
    h5py = h5py_module()
    with h5py.File(path, "r") as f:
        return sorted(f.keys())


def read_seed_data(path: str | Path, key: str) -> np.ndarray:
    h5py = h5py_module()
    with h5py.File(path, "r") as f:
        return np.asarray(f[key]["data"], dtype=np.float32)


def read_seed_grid(path: str | Path, key: str) -> dict[str, np.ndarray]:
    h5py = h5py_module()
    with h5py.File(path, "r") as f:
        g = f[key]["grid"]
        return {k: np.asarray(g[k], dtype=np.float32) for k in g.keys()}
