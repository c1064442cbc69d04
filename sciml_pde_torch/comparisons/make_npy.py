"""Velocity-HDF5 -> magnitude-frame .npy converter (port of
``sciml_pde_tpu/comparisons/make_npy.py``).

Accepts velocity arrays of rank 3-5 in channel-first or channel-last
layout, computes the speed |v| per frame, resizes it to ``size`` x ``size``
and stacks all frames of all files into one (N, size, size) float32 npy.

The resize is JAX's ``jax.image.resize(..., "bilinear")``, which
antialiases when it shrinks: a triangle kernel widened by the inverse
scale (``scale_and_translate``), not ``F.interpolate``'s bilinear.  Its two
separable weight matrices are built here in numpy and applied as two
products.  Files are read through ``io/h5.py::h5py_module``.

    python -m sciml_pde_torch.comparisons.make_npy --src DIR --out data/ns_mag64.npy
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of JAX's antialiased bilinear resize along one
    axis (``jax.image.compute_weight_mat`` with the triangle kernel, scale
    n_out / n_in, no translation)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def to_mag_frames(arr: np.ndarray, size: int = 64) -> np.ndarray:
    """Any supported velocity layout -> (N, size, size) float32 |v| frames."""
    a = np.asarray(arr)
    if a.shape[-1] == 2:
        pass
    elif a.shape[0] == 2:
        a = np.moveaxis(a, 0, -1)
    else:
        raise ValueError(f"can't find 2-channel axis in shape {a.shape}")
    if a.ndim == 5:  # (case, T, H, W, 2)
        a = a.reshape(-1, *a.shape[2:])
    elif a.ndim == 3:  # (H, W, 2)
        a = a[None]
    elif a.ndim != 4:
        raise ValueError(f"unsupported rank {a.ndim}")
    mag = np.linalg.norm(a, axis=-1).astype(np.float32)  # (N, H, W)
    out = mag.astype(np.float64)
    if mag.shape[1] != size:
        out = np.einsum("nhw,hi->niw", out, resize_weights(mag.shape[1], size))
    if mag.shape[2] != size:
        out = np.einsum("niw,wj->nij", out, resize_weights(mag.shape[2], size))
    return out.astype(np.float32)


def convert_dir(src_dir: str | Path, out_path: str | Path,
                velocity_key: str = "velocity", size: int = 64) -> Path:
    from sciml_pde_torch.io.h5 import h5py_module

    h5py = h5py_module()
    frames = []
    paths = sorted(glob.glob(str(Path(src_dir) / "*.h5")))
    if not paths:
        raise FileNotFoundError(f"no .h5 files under {src_dir}")
    for p in paths:
        with h5py.File(p, "r") as f:
            key = velocity_key if velocity_key in f else next(iter(f))
            frames.append(to_mag_frames(np.asarray(f[key]), size=size))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, np.concatenate(frames, axis=0))
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", required=True, help="dir of velocity .h5 files")
    p.add_argument("--out", default="data/ns_mag64.npy")
    p.add_argument("--key", default="velocity")
    p.add_argument("--size", type=int, default=64)
    a = p.parse_args(argv)
    out = convert_dir(a.src, a.out, velocity_key=a.key, size=a.size)
    print(f"wrote {out}: {np.load(out, mmap_mode='r').shape}")


if __name__ == "__main__":
    main()
