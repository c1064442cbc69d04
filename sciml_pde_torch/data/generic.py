"""A folder of HDF5 files as a dataset, with contiguous splits (port of
``sciml_pde_tpu/data/generic.py``).

``HDF5Dataset`` indexes the leading (trajectory) axis of every dataset in
every ``.h5`` file of a folder and returns an item dict per trajectory;
``HDF5DataModule`` splits it into contiguous train / val / test ranges and
yields batches of stacked dicts.  Host-side numpy, for exploratory tools.
Files open through ``io/h5.py::h5py_module``: h5py, or where it is missing
the port's own HDF5 subset (``io/hdf5_lite.py``, which reads h5py's chunked,
shuffled LZF and deflate files too).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sciml_pde_torch.io.h5 import h5py_module


class HDF5Dataset:
    """Every dataset of every .h5 file in a folder, indexed by trajectory.
    The datasets of a file share their leading axis; an item is read from
    its file when asked for."""

    def __init__(self, folder: str | Path, pattern: str = "*.h5"):
        h5py = h5py_module()
        self.files = sorted(Path(folder).glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no {pattern} files under {folder}")
        self._index: list[tuple[Path, int]] = []
        self._keys: dict[Path, list[str]] = {}
        for p in self.files:
            with h5py.File(p, "r") as f:
                keys = sorted(f.keys())
                lead = {f[k].shape[0] for k in keys}
                if len(lead) != 1:
                    raise ValueError(f"{p.name}: datasets disagree on leading dim ({lead})")
                self._keys[p] = keys
                self._index.extend((p, b) for b in range(lead.pop()))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        path, row = self._index[i]
        with h5py_module().File(path, "r") as f:
            return {k: np.asarray(f[k][row], np.float32) for k in self._keys[path]}


class HDF5DataModule:
    """Contiguous train / val / test splits (fractions ``splits``) over an
    ``HDF5Dataset``, iterated in batches of dicts of stacked arrays."""

    def __init__(self, folder: str | Path, batch_size: int = 1,
                 splits=(0.8, 0.1, 0.1), pattern: str = "*.h5"):
        if len(splits) != 3:
            raise ValueError("splits must be (train, val, test) fractions")
        self.dataset = HDF5Dataset(folder, pattern)
        self.batch_size = int(batch_size)
        n = len(self.dataset)
        n_train = int(splits[0] * n)
        n_val = int(splits[1] * n)
        self._ranges = {
            "train": range(0, n_train),
            "val": range(n_train, n_train + n_val),
            "test": range(n_train + n_val, n),
        }

    def iter_split(self, split: str):
        idx = self._ranges[split]
        for b in range(0, len(idx), self.batch_size):
            items = [self.dataset[idx[j]] for j in range(b, min(b + self.batch_size, len(idx)))]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
