"""Controlled fno_lie study at toy scale (port of the JAX package's
``experiments/ns_lie_toy.py``).

The reference sweeps a Lie-point-symmetry-augmented FNO baseline
(``pdebench/models/run_forward_ns.sh`` variant ``fno_lie``, engine
``pdebench/models/fno/transformations.py:17-179``, loader
``fno/utils_2d_ns_baseline_lie.py:161-209``) but publishes no numbers for
it.  This driver carves a toy dataset out of an existing 256^2 production
primary file (a strided spatial and temporal subsample; trajectories 0..2
-> the train file, trajectory 3 -> the test file 250) and trains the two
variants at one budget through the port's production driver
(``experiments/ns_production.py``), so the only difference is
``lie_augment``.  The files go through ``io/h5.py``: h5py where it is
installed, else the port's subset; LZF either way.

  python -m sciml_pde_torch.experiments.ns_lie_toy [--epochs 20] [--stride 4] \\
      [--src data/ns_production/ns_incom_inhom_2d_256-0.h5]

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_toy_folder(src: Path, folder: Path, stride: int, tstride: int = 1) -> None:
    """Train file ``ns_incom_inhom_2d_256-0.h5`` (trajectories 0..2) and test
    file ``-250.h5`` (trajectory 3) of ``src`` strided by ``stride`` in space
    and ``tstride`` in time, with ``src``'s attributes; kept where both
    exist."""
    from sciml_pde_torch.io.h5 import h5py_module

    h5py = h5py_module()
    folder.mkdir(parents=True, exist_ok=True)
    train_f = folder / "ns_incom_inhom_2d_256-0.h5"
    test_f = folder / "ns_incom_inhom_2d_256-250.h5"
    if train_f.exists() and test_f.exists():
        print(f"toy folder {folder} already built")
        return
    with h5py.File(src, "r") as f:
        vel = f["velocity"][:, ::tstride, ::stride, ::stride, :]
        part = f["particles"][:, ::tstride, ::stride, ::stride, :]
        force = f["force"][:, ::stride, ::stride, :]
        t = f["t"][:, ::tstride]
        cfg = dict(f.attrs)

    def write(path: Path, sl: slice) -> None:
        with h5py.File(path, "w") as f:
            for name, arr in [("velocity", vel[sl]), ("particles", part[sl]),
                              ("force", force[sl]), ("t", t[sl])]:
                f.create_dataset(name, data=arr, compression="lzf")
            for k, v in cfg.items():
                f.attrs[k] = v

    write(train_f, slice(0, 3))
    write(test_f, slice(3, 4))
    print(f"toy folder {folder}: train {vel[:3].shape}, test {vel[3:4].shape}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", default="data/ns_production/ns_incom_inhom_2d_256-0.h5")
    p.add_argument("--folder", default="data/ns_lie_toy")
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--tstride", type=int, default=1,
                   help="temporal subsample of the source trajectory")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", default="runs/ns_lie_toy")
    p.add_argument("--variants", nargs="+", default=["baseline", "lie"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.experiments.ns_production import main as ns_main

    dev = resolve_device(a.device)
    build_toy_folder(Path(a.src), Path(a.folder), a.stride, a.tstride)
    ns_main(["--skip-gen", "--folder", a.folder, "--variants", *a.variants,
             "--n-primary", "1", "--n-test", "1", "--epochs", str(a.epochs),
             "--batch-size", str(a.batch_size), "--out", a.out,
             "--tag", f"toy{256 // a.stride}", "--device", str(dev)])
    summary = json.loads((Path(a.out) / "summary.json").read_text())
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
