"""CLI: convert PDEBench 3D CFD velocity HDF5 (Vx/Vy/Vz) to vorticity files
(port of ``sciml_pde_tpu/sim/velocity2vorticity.py``; reference
``pdebench/data_gen/velocity2vorticity.py``): reads Vx/Vy/Vz (+ x/y/z/t
coordinates), computes the spectral vorticity on the card in batches of
trajectories, and writes ``omega_x/y/z`` into a ``*_vorticity.h5`` sibling
file.

  python -m sciml_pde_torch.sim.velocity2vorticity data/3D_CFD.h5 [--batch 4]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.sim.vorticity import compute_spectral_vorticity_jnp


@torch.no_grad()
def convert_velocity(h5path: str | Path, batch: int = 4, device=None) -> Path:
    dev = resolve_device(device)
    h5path = Path(h5path)
    out = h5path.with_name(h5path.stem + "_vorticity.h5")
    h5py = h5io.h5py_module()
    with h5py.File(h5path, "r") as fin, h5py.File(out, "w") as fout:
        vx, vy, vz = fin["Vx"], fin["Vy"], fin["Vz"]  # (N, T, X, Y, Z) or (T, X, Y, Z)
        for key in ("x-coordinate", "y-coordinate", "z-coordinate", "t-coordinate"):
            if key in fin:
                fout.create_dataset(key, data=np.asarray(fin[key]))

        def step(key):
            if key not in fin:
                return 1.0
            c = np.asarray(fin[key])
            return float(c[1] - c[0])

        dx, dy, dz = step("x-coordinate"), step("y-coordinate"), step("z-coordinate")
        shape = vx.shape
        outs = {
            k: fout.create_dataset(k, shape, dtype="float32", compression="lzf")
            for k in ("omega_x", "omega_y", "omega_z")
        }
        n = shape[0]
        for i in range(0, n, batch):
            sl = slice(i, min(i + batch, n))
            vel = torch.stack([torch.as_tensor(np.asarray(d[sl], np.float32), device=dev)
                               for d in (vx, vy, vz)], dim=-1)
            sx, sy, sz = vel.shape[-4:-1]
            w = compute_spectral_vorticity_jnp(
                vel.reshape((-1, sx, sy, sz, 3)), sx * dx, sy * dy, sz * dz
            ).reshape(vel.shape).cpu().numpy()
            outs["omega_x"][sl] = w[..., 0]
            outs["omega_y"][sl] = w[..., 1]
            outs["omega_z"][sl] = w[..., 2]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="PDEBench 3D CFD hdf5 with Vx/Vy/Vz")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    out = convert_velocity(a.input, a.batch, device=a.device)
    print(out)


if __name__ == "__main__":
    main()
