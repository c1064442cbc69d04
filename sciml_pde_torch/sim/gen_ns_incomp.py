"""CLI: generate 2D incompressible NS datasets, full and decomposed forms
(port of ``sciml_pde_tpu/sim/gen_ns_incomp.py``).

The batched simulation runs on the card (``sim/ns_incomp_2d.py``); frames
come back to an HDF5 file with the reference's schema
(``data_gen/src/data_io.py:17-58``):

  {sim_name}-{seed}.h5:
    velocity  (B, T, X, Y, 2)  float32, lzf, chunks (1,1,X,Y,2), shuffle
    particles (B, T, X, Y, 1)
    force     (B, X, Y, 2)
    t         (B, T)
    attrs: config (json), latestIndex

so ``data/ns.py`` and the JAX package's loader both read it.  The
``--variant`` knob makes the decomposed "basic physics form" aux datasets:
``convection`` drops diffusion and forcing, ``diffusion`` drops advection
and forcing, ``no_pressure`` drops the projection.

  python -m sciml_pde_torch.sim.gen_ns_incomp --out-dir data/ns --n-files 2 \\
      --grid 256 --n-steps 100000 --frame-int 100 --n-batch 4

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.sim.ns_incomp_2d import NSIncompConfig, simulate_ns_batch

VARIANTS = {
    "full": {},
    "convection": {"enable_diffusion": False, "enable_force": False},
    "diffusion": {"enable_advection": False, "enable_force": False,
                  "enable_projection": False},
    "no_pressure": {"enable_projection": False},
    # out-of-distribution eval variant: different viscosity/forcing regime
    "ood": {"nu": 0.01, "force_scale": 0.8},
}


def write_ns_h5(path: str | Path, vel, par, force, ts, config: dict):
    vel = np.asarray(vel, np.float32)
    par = np.asarray(par, np.float32)
    force = np.asarray(force, np.float32)
    ts = np.asarray(ts, np.float32)
    with h5io.h5py_module().File(path, "w") as f:
        f.attrs["config"] = json.dumps(config)
        f.attrs["latestIndex"] = vel.shape[1] - 1
        for name, arr in [("velocity", vel), ("particles", par), ("force", force), ("t", ts)]:
            chunks = (1, 1, *arr.shape[2:]) if arr.ndim > 2 else None
            f.create_dataset(
                name, data=arr, dtype="float32", compression="lzf",
                chunks=chunks, shuffle=True,
            )


def generate_ns_file(
    out_path: str | Path, seed: int, cfg: NSIncompConfig,
    config_dict: dict | None = None, frames_per_chunk: int = 0, device=None,
):
    """Simulate ``cfg.n_batch`` trajectories from ``seed`` and write them.
    ``frames_per_chunk`` > 0 streams the frames into the growing file every
    that many frames (device memory holds one chunk, host memory none of the
    trajectory), through a temporary file renamed at the end, so a crash
    mid-write never leaves a plausible-looking file."""
    if not frames_per_chunk:
        vel, par, force, ts = simulate_ns_batch(seed, cfg, device=device)
        write_ns_h5(out_path, vel, par, force, ts, config_dict or dataclasses.asdict(cfg))
        return

    nx, ny = cfg.grid_size
    b, t = cfg.n_batch, cfg.n_frames
    out_path = Path(out_path)
    tmp_path = out_path.with_suffix(out_path.suffix + ".tmp")
    with h5io.h5py_module().File(tmp_path, "w") as f:
        f.attrs["config"] = json.dumps(config_dict or dataclasses.asdict(cfg))
        f.attrs["latestIndex"] = t - 1
        dvel = f.create_dataset("velocity", (b, t, nx, ny, 2), dtype="float32",
                                compression="lzf", chunks=(1, 1, nx, ny, 2), shuffle=True)
        dpar = f.create_dataset("particles", (b, t, nx, ny, 1), dtype="float32",
                                compression="lzf", chunks=(1, 1, nx, ny, 1), shuffle=True)
        pos = {"i": 0}

        def cb(vel_c, par_c):
            i0, n = pos["i"], vel_c.shape[1]
            dvel[:, i0 : i0 + n] = vel_c
            dpar[:, i0 : i0 + n] = par_c
            pos["i"] = i0 + n

        _, _, force, ts = simulate_ns_batch(
            seed, cfg, frames_per_chunk=frames_per_chunk, frame_callback=cb, device=device
        )
        if pos["i"] != t:
            raise RuntimeError(f"wrote {pos['i']} of {t} frames")
        f.create_dataset("force", data=np.asarray(force, np.float32),
                         compression="lzf", chunks=(1, nx, ny, 2), shuffle=True)
        f.create_dataset("t", data=np.asarray(ts, np.float32), compression="lzf")
    tmp_path.replace(out_path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sim-name", default="ns_incom_inhom_2d_256")
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--n-files", type=int, default=1)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="full")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--nu", type=float, default=0.05)
    p.add_argument("--dt", type=float, default=5e-5)
    p.add_argument("--n-steps", type=int, default=100_000)
    p.add_argument("--frame-int", type=int, default=100)
    p.add_argument("--n-batch", type=int, default=4)
    p.add_argument("--plot", action="store_true",
                   help="write a field-strip preview png next to each file "
                        "(reference data_gen/src/plots.py)")
    p.add_argument("--gif", action="store_true",
                   help="with --plot: also write an animation gif")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    cfg = NSIncompConfig(
        grid_size=(a.grid, a.grid), nu=a.nu, dt=a.dt,
        n_steps=a.n_steps, frame_int=a.frame_int, n_batch=a.n_batch,
        **VARIANTS[a.variant],
    )
    out_dir = Path(a.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for seed in range(a.seed_start, a.seed_start + a.n_files):
        t0 = time.time()
        out = out_dir / f"{a.sim_name}-{seed}.h5"
        generate_ns_file(out, seed, cfg, device=a.device)
        print(f"{out}: {time.time()-t0:.1f}s", flush=True)
        if a.plot:
            from sciml_pde_torch.sim.preview import preview_dataset

            for w in preview_dataset(out, gif=a.gif):
                print(w)


if __name__ == "__main__":
    main()
