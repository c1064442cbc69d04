"""2D steady boundary-value problems: electro- and magneto-statics (port
of ``sciml_pde_tpu/sim/bvp_2d.py``).

Generates the point-cloud BVP datasets the reference's BVP suite trains
on (``OFormer Model Comparison/BVP/train_electro.py`` /
``train_magneto.py`` + ``dataset_new.ElectroStatData``): each case is a
variable-size scattered node set with an 11-column feature matrix
``data_x`` and a 3-column label matrix ``data_y`` ([scalar potential,
field_x, field_y]), shipped as a pickle list of dicts.  The reference
repo consumes a proprietary FEM export and includes no generator; this
module produces the same PROTOCOL (shapes, dtypes, boundary-flag
column, pickle schema) from a real discrete BVP solve:

  electro:  del^2 phi = -rho      (grounded box),  E = -grad phi
  magneto:  del^2 A_z = -mu j_z   (far-field box), B = curl(A_z 2D)
                                   = (dA/dy, -dA/dx)

The solve is an exact eigendecomposition of the 5-point Dirichlet
Laplacian via DST-I (odd-extension real FFT), one frequency-space divide,
on the card.  The sources and nodes are drawn from
``np.random.default_rng(seed)``, as JAX's are, so the port's cases hold
the same sources and nodes as JAX's; only the solve's f32 rounding
differs.  Nodes are sampled FEM-like (boundary rings + interior points
refined near sources), and fields are bilinearly interpolated.

data_x columns (the reference's loader uses col 0-1 as coords and col 3
as the boundary flag, ``dataset_new.py:471-475``; the remaining column
semantics are not recoverable from the reference code, so they are
defined here and documented):
  0 x, 1 y, 2 source density at node, 3 boundary flag (1.0 on the box),
  4 boundary value (0 for grounded), 5 material coefficient (eps/mu),
  6 distance to nearest wall, 7-8 offset to strongest source,
  9 strongest source strength, 10 local node spacing estimate.

  python -m sciml_pde_torch.sim.bvp_2d --out data/bvp/electro_train.pkl --kind electro

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device


# --------------------------------------------------------------------------
# Dirichlet Poisson solve via DST-I
# --------------------------------------------------------------------------


def _dst1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """DST-I along ``axis`` via odd extension + rfft (length n -> 2n+2)."""
    n = x.shape[axis]
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    rev = torch.flip(x, (axis,))
    ext = torch.cat([z, x, z, -rev], dim=axis)  # length 2n+2, odd
    f = torch.fft.rfft(ext, dim=axis)
    return -torch.imag(f.narrow(axis if axis >= 0 else f.ndim + axis, 1, n))


@torch.no_grad()
def poisson_dirichlet(rho: torch.Tensor, dx: float) -> torch.Tensor:
    """Solve del^2 phi = -rho on the interior of a grounded box, on
    ``rho``'s device.

    ``rho``: (n, n) interior samples (boundary value 0 implied).  Exact
    inverse of the 5-point Laplacian: DST-I diagonalizes it with
    eigenvalues (2-2cos(pi k/(n+1)))/dx^2.
    """
    n = rho.shape[-1]
    k = torch.arange(1, n + 1, dtype=rho.dtype, device=rho.device)
    lam = (2.0 - 2.0 * torch.cos(math.pi * k / (n + 1))) / dx**2
    lam2 = lam[:, None] + lam[None, :]
    rho_hat = _dst1(_dst1(rho, -1), -2)
    phi_hat = rho_hat / lam2
    # _dst1 returns 2x the DST-I, and DST-I's self-inverse scale is
    # (n+1)/2, so one forward+inverse pass per axis multiplies by
    # 2*2*(n+1)/2 = 2(n+1): normalize by (2(n+1))^2 for the 2D pair.
    phi = _dst1(_dst1(phi_hat, -1), -2) / (2 * (n + 1)) ** 2
    return phi


# --------------------------------------------------------------------------
# case generation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BVPConfig:
    kind: str = "electro"  # electro | magneto
    grid: int = 128        # interior grid resolution for the solve
    n_sources: tuple[int, int] = (2, 5)
    min_points: int = 600
    max_points: int = 1024
    coeff_range: tuple[float, float] = (0.5, 2.0)  # eps or mu


def _solve_case(rng: np.random.Generator, cfg: BVPConfig, device=None):
    """One BVP solve on the grid (on ``device``); returns (rho, phi, fx, fy,
    sources, coeff)."""
    n = cfg.grid
    dx = 1.0 / (n + 1)
    xs = (np.arange(1, n + 1) * dx).astype(np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")

    n_src = int(rng.integers(cfg.n_sources[0], cfg.n_sources[1] + 1))
    pos = rng.uniform(0.2, 0.8, size=(n_src, 2)).astype(np.float32)
    q = rng.uniform(0.5, 2.0, size=n_src).astype(np.float32)
    q *= rng.choice([-1.0, 1.0], size=n_src).astype(np.float32)
    w = rng.uniform(0.02, 0.06, size=n_src).astype(np.float32)
    coeff = float(rng.uniform(*cfg.coeff_range))

    rho = np.zeros((n, n), np.float32)
    for p, qi, wi in zip(pos, q, w):
        r2 = (gx - p[0]) ** 2 + (gy - p[1]) ** 2
        rho += qi * np.exp(-r2 / (2 * wi**2)) / (2 * np.pi * wi**2)

    phi = poisson_dirichlet(torch.as_tensor(rho / coeff, device=resolve_device(device)),
                            dx).cpu().numpy()
    # field on the interior grid: E = -grad phi (electro) with phi=0 walls;
    # B = (dA/dy, -dA/dx) (magneto)
    phi_pad = np.pad(phi, 1)  # boundary value 0
    dpx = (phi_pad[2:, 1:-1] - phi_pad[:-2, 1:-1]) / (2 * dx)
    dpy = (phi_pad[1:-1, 2:] - phi_pad[1:-1, :-2]) / (2 * dx)
    if cfg.kind == "electro":
        fx, fy = -dpx, -dpy
    else:
        fx, fy = dpy, -dpx
    return rho, phi, fx, fy, (pos, q, w), coeff


def _bilinear(grid_vals: np.ndarray, pts: np.ndarray, dx: float) -> np.ndarray:
    """Sample (n, n) interior grid (node i at (i+1)*dx) at points (P, 2)."""
    n = grid_vals.shape[0]
    f = pts / dx - 1.0
    i0 = np.clip(np.floor(f[:, 0]).astype(int), 0, n - 2)
    j0 = np.clip(np.floor(f[:, 1]).astype(int), 0, n - 2)
    a = np.clip(f[:, 0] - i0, 0.0, 1.0)
    b = np.clip(f[:, 1] - j0, 0.0, 1.0)
    v00 = grid_vals[i0, j0]
    v10 = grid_vals[i0 + 1, j0]
    v01 = grid_vals[i0, j0 + 1]
    v11 = grid_vals[i0 + 1, j0 + 1]
    return (v00 * (1 - a) * (1 - b) + v10 * a * (1 - b)
            + v01 * (1 - a) * b + v11 * a * b).astype(np.float32)


def generate_case(seed: int, cfg: BVPConfig, device=None) -> dict:
    """One reference-schema case: {'data_x': (P, 11), 'data_y': (P, 3)}.
    The sources and nodes come from ``np.random.default_rng(seed)``, as
    JAX's do; the solve runs on ``device``."""
    rng = np.random.default_rng(seed)
    rho, phi, fx, fy, (pos, q, w), coeff = _solve_case(rng, cfg, device)
    dx = 1.0 / (cfg.grid + 1)

    n_pts = int(rng.integers(cfg.min_points, cfg.max_points + 1))
    n_bnd = max(n_pts // 8, 16)
    n_int = n_pts - n_bnd

    # interior nodes: uniform + refinement near sources (FEM-like density)
    n_ref = n_int // 3
    pts_u = rng.uniform(dx, 1.0 - dx, size=(n_int - n_ref, 2))
    src_pick = rng.integers(0, len(q), size=n_ref)
    pts_r = pos[src_pick] + rng.normal(scale=3 * w[src_pick][:, None], size=(n_ref, 2))
    pts_int = np.clip(np.concatenate([pts_u, pts_r]), dx, 1.0 - dx)

    # boundary nodes on the box walls
    t = rng.uniform(0, 1, size=n_bnd)
    side = rng.integers(0, 4, size=n_bnd)
    pts_bnd = np.zeros((n_bnd, 2))
    pts_bnd[side == 0] = np.stack([t[side == 0], np.zeros((side == 0).sum())], 1)
    pts_bnd[side == 1] = np.stack([t[side == 1], np.ones((side == 1).sum())], 1)
    pts_bnd[side == 2] = np.stack([np.zeros((side == 2).sum()), t[side == 2]], 1)
    pts_bnd[side == 3] = np.stack([np.ones((side == 3).sum()), t[side == 3]], 1)

    pts = np.concatenate([pts_int, pts_bnd]).astype(np.float32)
    bound = np.zeros(n_pts, np.float32)
    bound[n_int:] = 1.0

    rho_n = _bilinear(rho, np.clip(pts, dx, 1 - dx), dx)
    phi_n = np.where(bound > 0, 0.0, _bilinear(phi, np.clip(pts, dx, 1 - dx), dx))
    fx_n = _bilinear(fx, np.clip(pts, dx, 1 - dx), dx)
    fy_n = _bilinear(fy, np.clip(pts, dx, 1 - dx), dx)

    # feature columns (module docstring)
    k_str = int(np.argmax(np.abs(q)))
    dist_wall = np.minimum.reduce(
        [pts[:, 0], 1 - pts[:, 0], pts[:, 1], 1 - pts[:, 1]])
    spacing = np.full(n_pts, 1.0 / np.sqrt(n_pts), np.float32)
    data_x = np.stack(
        [
            pts[:, 0], pts[:, 1], rho_n, bound,
            np.zeros(n_pts, np.float32),              # boundary value
            np.full(n_pts, coeff, np.float32),
            dist_wall.astype(np.float32),
            (pts[:, 0] - pos[k_str, 0]).astype(np.float32),
            (pts[:, 1] - pos[k_str, 1]).astype(np.float32),
            np.full(n_pts, q[k_str], np.float32),
            spacing,
        ],
        axis=1,
    ).astype(np.float32)
    data_y = np.stack([phi_n, fx_n, fy_n], axis=1).astype(np.float32)
    return {"data_x": data_x, "data_y": data_y}


def generate_dataset(path, n_cases: int, cfg: BVPConfig, seed0: int = 0, device=None):
    """Write the reference pickle schema: a list of case dicts."""
    dev = resolve_device(device)
    cases = [generate_case(seed0 + s, cfg, dev) for s in range(n_cases)]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("wb") as f:
        pickle.dump(cases, f)
    return cases


def load_pointset(path) -> dict:
    """Reference pickle -> padded arrays for ``run_pointset_training``.

    Mirrors ``ElectroStatData.prepare_data/pad_data``: pad every case to
    the max node count, boolean pad + boundary masks from column 3.
    """
    with Path(path).open("rb") as f:
        cases = pickle.load(f)
    max_p = max(c["data_x"].shape[0] for c in cases)
    n = len(cases)
    fdim = cases[0]["data_x"].shape[1]
    feats = np.zeros((n, max_p, fdim), np.float32)
    coords = np.zeros((n, max_p, 2), np.float32)
    pad = np.zeros((n, max_p), bool)
    bound = np.zeros((n, max_p), bool)
    scalar = np.zeros((n, max_p, 1), np.float32)
    field = np.zeros((n, max_p, 2), np.float32)
    for i, c in enumerate(cases):
        p = c["data_x"].shape[0]
        feats[i, :p] = c["data_x"]
        coords[i, :p] = c["data_x"][:, :2]
        pad[i, :p] = True
        bound[i, :p] = np.abs(c["data_x"][:, 3] - 1.0) < 1e-10
        scalar[i, :p] = c["data_y"][:, :1]
        field[i, :p] = c["data_y"][:, 1:]
    return {
        "features": feats, "coords": coords, "pad_mask": pad,
        "bound_mask": bound, "scalar": scalar, "field": field,
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--kind", choices=["electro", "magneto"], default="electro")
    p.add_argument("--n-cases", type=int, default=200)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    cfg = BVPConfig(kind=a.kind, grid=a.grid)
    cases = generate_dataset(a.out, a.n_cases, cfg, a.seed_start, device=a.device)
    sizes = [c["data_x"].shape[0] for c in cases]
    print(f"{a.out}: {len(cases)} {a.kind} cases, "
          f"{min(sizes)}..{max(sizes)} nodes")


if __name__ == "__main__":
    main()
