"""CLI: generate 2D diffusion-reaction datasets, full and decomposed forms
(port of ``sciml_pde_tpu/sim/gen_diff_react.py``).

Seeds are batched ``--device-batch`` at a time and integrated together on
the card (``sim/diff_react.py``); each trajectory becomes one seed group of
the HDF5 schema in ``io/h5.py``, a batch's groups appended in one session
of the file.  A re-run skips the seed groups the file already holds.

Example (the three datasets the aux-training experiments need):
  python -m sciml_pde_torch.sim.gen_diff_react --out data/2D_diff-react_test_all.h5   --nsample 100 --sim-type all
  python -m sciml_pde_torch.sim.gen_diff_react --out data/2D_diff-react_test_diff.h5  --nsample 300 --sim-type diff
  python -m sciml_pde_torch.sim.gen_diff_react --out data/2D_diff-react_test_react.h5 --nsample 300 --sim-type react

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io.h5 import write_seed_groups
from sciml_pde_torch.sim.diff_react import DiffReactConfig, generate_trajectories


def generate_dataset(
    out_path: str | Path,
    nsample: int,
    cfg: DiffReactConfig,
    seed_start: int = 0,
    device_batch: int = 8,
    verbose: bool = True,
    device=None,
) -> None:
    dev = resolve_device(device)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cfg_yaml = json.dumps(dataclasses.asdict(cfg))
    seeds = list(range(seed_start, seed_start + nsample))
    if out_path.exists():
        # resume: a re-run must not die on groups an earlier run wrote
        with h5io.h5py_module().File(out_path, "r") as f:
            done = set(f.keys())
        skipped = [s for s in seeds if str(s).zfill(4) in done]
        seeds = [s for s in seeds if str(s).zfill(4) not in done]
        if verbose and skipped:
            print(f"resume: skipping {len(skipped)} seeds already in {out_path}")
    for i in range(0, len(seeds), device_batch):
        chunk = seeds[i : i + device_batch]
        t0 = time.time()
        data = generate_trajectories(chunk, cfg, device=dev)
        write_seed_groups(out_path, {s: data[j] for j, s in enumerate(chunk)}, cfg.x, cfg.y,
                          cfg.tgrid, cfg_yaml)
        if verbose:
            print(
                f"seeds {chunk[0]}..{chunk[-1]}: {time.time()-t0:.2f}s "
                f"({len(chunk)} trajectories of {cfg.tdim}x{cfg.ydim}x{cfg.xdim}x2)"
            )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--nsample", type=int, default=100)
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--sim-type", choices=["all", "react", "diff"], default="all")
    p.add_argument("--xdim", type=int, default=128)
    p.add_argument("--ydim", type=int, default=128)
    p.add_argument("--tdim", type=int, default=101)
    p.add_argument("--t", type=float, default=5.0)
    p.add_argument("--Du", type=float, default=1e-3)
    p.add_argument("--Dv", type=float, default=1e-1)
    p.add_argument("--k", type=float, default=5e-3)
    p.add_argument("--device-batch", type=int, default=8)
    p.add_argument("--plot", action="store_true",
                   help="write a field-strip preview png next to the file "
                        "(reference data_gen/src/plots.py)")
    p.add_argument("--gif", action="store_true",
                   help="with --plot: also write an animation gif")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    cfg = DiffReactConfig(
        Du=a.Du, Dv=a.Dv, k=a.k, t=a.t, tdim=a.tdim,
        xdim=a.xdim, ydim=a.ydim, sim_type=a.sim_type,
    )
    generate_dataset(a.out, a.nsample, cfg, a.seed_start, a.device_batch, device=a.device)
    if a.plot:
        from sciml_pde_torch.sim.preview import preview_dataset

        for w in preview_dataset(a.out, gif=a.gif):
            print(w)


if __name__ == "__main__":
    main()
