"""CLI: create spatiotemporally downsampled DR dataset files (port of
``sciml_pde_tpu/sim/downsample_dr.py``; numpy only, the port's own copy).

The reference experiments read pre-made downsampled aux pools
(``2D_diff-react_downsample_t50_96.h5``: full physics at 50 frames x 96^2;
``2D_diff-react_decomp_downsample.h5``: the decomposed form) but ship no
tool that makes them.  This CLI reads a full DR file (seed-group schema,
``io/h5.py``) and writes the same schema at a reduced (T, H, W):

  python -m sciml_pde_torch.sim.downsample_dr \\
      --src data/2D_diff-react_test_all.h5 \\
      --out data/2D_diff-react_downsample_t50_96.h5 --tdim 50 --res 96
  python -m sciml_pde_torch.sim.downsample_dr \\
      --src data/2D_diff-react_test_diff.h5 \\
      --out data/2D_diff-react_decomp_downsample.h5 --tdim 50 --res 96

for the ``ts_down`` / ``tsdecomp_down`` sweep variants.  Resampling is
align-corners linear per axis, the adjoint regime of the loader's
trilinear upsample (``data/dr._resize_trilinear``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io.h5 import create_seed_group


def _resize_linear_axis(a: np.ndarray, axis: int, n: int) -> np.ndarray:
    """Align-corners linear resample of one axis."""
    m = a.shape[axis]
    if m == n:
        return a
    pos = np.linspace(0, m - 1, n)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, m - 1)
    w = (pos - lo).astype(a.dtype)
    a_lo = np.take(a, lo, axis=axis)
    a_hi = np.take(a, hi, axis=axis)
    shape = [1] * a.ndim
    shape[axis] = n
    return a_lo + (a_hi - a_lo) * w.reshape(shape)


def downsample_file(
    src: str | Path, out: str | Path, tdim: int, res: int, verbose: bool = True
) -> int:
    """Downsample every seed group of ``src`` into ``out``; returns count.
    The groups are written in one session of a temporary file, renamed to
    ``out`` at the end, so a run that stops leaves no ``out``."""
    h5py = h5io.h5py_module()
    src, out = Path(src), Path(out)
    if out.exists():
        raise FileExistsError(f"{out} already exists")
    tmp = out.with_suffix(out.suffix + ".tmp")
    n = 0
    with h5py.File(src, "r") as f, h5py.File(tmp, "w") as fout:
        keys = sorted(f.keys())
        for key in keys:
            data = np.asarray(f[key]["data"], np.float32)  # (T, H, W, C)
            g = f[key]["grid"]
            x = np.asarray(g["x"], np.float32)
            y = np.asarray(g["y"], np.float32)
            t = np.asarray(g["t"], np.float32)
            cfg = f[key].attrs.get("config", "")
            for axis, target in ((0, tdim), (1, res), (2, res)):
                data = _resize_linear_axis(data, axis, target)
            create_seed_group(
                fout, int(key),
                data.astype(np.float32),
                _resize_linear_axis(x, 0, res),
                _resize_linear_axis(y, 0, res),
                _resize_linear_axis(t, 0, tdim),
                str(cfg),
            )
            n += 1
            if verbose and n % 50 == 0:
                print(f"{n}/{len(keys)} seeds", flush=True)
    tmp.replace(out)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--tdim", type=int, default=50)
    p.add_argument("--res", type=int, default=96)
    a = p.parse_args(argv)
    n = downsample_file(a.src, a.out, a.tdim, a.res)
    print(f"wrote {n} seeds to {a.out} at ({a.tdim}, {a.res}, {a.res})")


if __name__ == "__main__":
    main()
