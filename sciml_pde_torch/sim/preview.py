"""Field renders of generated datasets (port of ``sciml_pde_tpu/sim/preview.py``;
reference ``data_gen/src/plots.py``).

Schema-aware previews of the HDF5 layouts:

  - DR files: per-seed groups ``{seed:04d}/data`` of (T, X, Y, 2);
  - NS files: datasets ``velocity`` (B, T, X, Y, 2) / ``particles``
    (B, T, X, Y, 1).

``preview_dataset`` writes ``<file>.preview.png`` (frame strip at 5
times) and optionally ``<file>.preview.gif``; both gen CLIs expose it as
``--plot [--gif]``, and it runs standalone:

  python -m sciml_pde_torch.sim.preview data/foo.h5 [--gif] [--channel 0]

It draws with PIL (``plots/figures.py``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sciml_pde_torch.io import h5 as h5io


def _load_first_trajectory(path: Path) -> np.ndarray:
    """-> (T, X, Y, C) of the file's first trajectory, either schema."""
    h5py = h5io.h5py_module()
    with h5py.File(path, "r") as f:
        if "velocity" in f:  # NS schema
            vel = f["velocity"][0]  # (T, X, Y, 2)
            if "particles" in f:
                return np.concatenate([vel, f["particles"][0]], axis=-1)
            return vel
        keys = sorted(k for k in f.keys() if isinstance(f[k], h5py.Group))
        if not keys:
            raise ValueError(f"{path}: no trajectory groups or velocity dataset")
        return np.asarray(f[keys[0]]["data"])


def preview_dataset(
    path: str | Path,
    gif: bool = False,
    channel: int = 0,
    n_frames: int = 5,
    fps: int = 10,
) -> list[Path]:
    from sciml_pde_torch.plots.figures import field_animation, image_row

    path = Path(path)
    traj = _load_first_trajectory(path)
    written: list[Path] = []

    t_idx = np.linspace(0, traj.shape[0] - 1, n_frames).astype(int)
    png = path.with_suffix(".preview.png")
    # row 0 at the top, as imshow draws a frame by default
    image_row(png, [(traj[t, ::-1, :, channel], None, None) for t in t_idx],
              [f"t={t}" for t in t_idx], f"{path.name} ch{channel}")
    written.append(png)

    if gif:
        out = path.with_suffix(".preview.gif")
        field_animation(out, traj, channel=channel, fps=fps, title=path.name)
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path")
    p.add_argument("--gif", action="store_true")
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--fps", type=int, default=10)
    a = p.parse_args(argv)
    for w in preview_dataset(a.path, gif=a.gif, channel=a.channel, fps=a.fps):
        print(w)


if __name__ == "__main__":
    main()
