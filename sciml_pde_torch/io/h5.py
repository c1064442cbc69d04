"""HDF5 seed-group reads (port of ``sciml_pde_tpu/io/h5.py``).

Diffusion-reaction layout, as the JAX package's simulators write it:
  /{seed:04d}/data          (T, Ny, Nx, C) float32
  /{seed:04d}/grid/{x,y,t}  float32

``h5py`` is imported inside each function, so the package imports on a
host that has no ``h5py``.  Writing waits for the simulator slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def list_seed_groups(path: str | Path) -> list[str]:
    import h5py

    with h5py.File(path, "r") as f:
        return sorted(f.keys())


def read_seed_data(path: str | Path, key: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[key]["data"], dtype=np.float32)


def read_seed_grid(path: str | Path, key: str) -> dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        g = f[key]["grid"]
        return {k: np.asarray(g[k], dtype=np.float32) for k in g.keys()}
