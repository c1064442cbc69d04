"""2D Darcy flow data generator, PDEBench file format (port of
``sciml_pde_tpu/sim/darcy_2d.py``).

The reference's OFormer comparison trains a steady-state operator on
PDEBench/FNO Darcy datasets ("OFormer Model Comparison/nn_module/
train_darcy.py") but the fork ships no generator.  This provides one:

  -div( a(x) grad u(x) ) = f   on the unit square,  u = 0 on the boundary,

with a(x) a two-valued thresholded Gaussian random field (the FNO-paper
coefficient family: a = hi where GRF >= 0 else lo) and constant forcing
f = beta (the PDEBench DarcyFlow convention).

Discretisation: cell-centred 5-point FVM with harmonic-mean face
coefficients and Dirichlet ghost cells; the solve is matrix-free
Jacobi-preconditioned CG with JAX's ``jax.scipy.sparse.linalg.cg``
arithmetic: the (N, X, Y) batch is ONE vector, so alpha, beta and the stop
test ``|r|^2 > max(tol^2 |b|^2, atol^2)`` are scalars over the whole
batch, and a file depends on ``--batch`` as JAX's does.  The loop runs on
the device; the host reads the stop flag every 8 iterations (a stopped
loop's state is kept by masks), so it stops at JAX's iteration.

The GRF draws come from an explicit ``torch.Generator`` (``sim/grf.py``);
the port cannot reproduce JAX's PRNG bits, so parity with JAX is held on
JAX's coefficient fields.

On-disk format (PDEBench 2D_DarcyFlow_beta*.hdf5), written through
``io/h5.py::h5py_module``:
  /nu            (N, X, Y) float32   — the coefficient field a(x)
  /tensor        (N, 1, X, Y) float32 — the solution u(x)
  /x-coordinate  (X,)
  /y-coordinate  (Y,)
  attrs: beta

  python -m sciml_pde_torch.sim.darcy_2d --out data/2D_DarcyFlow_beta1.0.h5

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.sim.grf import grf_rbf
from sciml_pde_torch.sim.ns_incomp_2d import _CG_CHECK


def threshold_coefficient(g: torch.Tensor, hi: float = 12.0, lo: float = 3.0) -> torch.Tensor:
    """The two-valued coefficient of GRF samples ``g``: hi where g >= 0."""
    return torch.where(g >= 0.0, hi, lo).to(torch.float32)


def sample_coefficient(generator: torch.Generator, n: int, nx: int, ny: int,
                       hi: float = 12.0, lo: float = 3.0, length_scale: float = 0.1,
                       device=None) -> torch.Tensor:
    """(N, X, Y) piecewise-constant thresholded-GRF coefficient, the N
    fields drawn in turn from ``generator``."""
    dev = resolve_device(device)
    g = torch.stack([grf_rbf(generator, (nx, ny), length_scale, device=dev) for _ in range(n)])
    return threshold_coefficient(g, hi, lo)


def _face_coeffs(a: torch.Tensor, h: float):
    """Harmonic-mean transmissibilities on the four faces of each cell.

    Boundary faces keep the cell's own coefficient (ghost cell mirrors a,
    u_ghost = -u so that u = 0 on the face).
    """
    def harm(p, q):
        return 2.0 * p * q / (p + q)

    aw = torch.cat([a[:, :1], harm(a[:, :-1], a[:, 1:])], dim=1)
    ae = torch.cat([harm(a[:, :-1], a[:, 1:]), a[:, -1:]], dim=1)
    as_ = torch.cat([a[:, :, :1], harm(a[:, :, :-1], a[:, :, 1:])], dim=2)
    an = torch.cat([harm(a[:, :, :-1], a[:, :, 1:]), a[:, :, -1:]], dim=2)
    scale = 1.0 / (h * h)
    # Dirichlet ghost: flux through a boundary face is 2*a/h^2 * u_cell
    bw, be, bs, bn = (torch.zeros_like(x) for x in (aw, ae, as_, an))
    bw[:, 0] = aw[:, 0]
    be[:, -1] = ae[:, -1]
    bs[:, :, 0] = as_[:, :, 0]
    bn[:, :, -1] = an[:, :, -1]
    return (aw * scale, ae * scale, as_ * scale, an * scale,
            bw * scale, be * scale, bs * scale, bn * scale)


def darcy_operator(a: torch.Tensor, h: float):
    """Returns (matvec, diag) for A u = -div(a grad u), batched (N,X,Y)."""
    aw, ae, as_, an, bw, be, bs, bn = _face_coeffs(a, h)
    diag = aw + ae + as_ + an + bw + be + bs + bn

    def matvec(u):
        uw = torch.cat([torch.zeros_like(u[:, :1]), u[:, :-1]], dim=1)
        ue = torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)
        us = torch.cat([torch.zeros_like(u[:, :, :1]), u[:, :, :-1]], dim=2)
        un = torch.cat([u[:, :, 1:], torch.zeros_like(u[:, :, :1])], dim=2)
        return diag * u - aw * uw - ae * ue - as_ * us - an * un

    return matvec, diag


def _vdot(x, y):
    return (x * y).sum()


def cg_jacobi(matvec, b: torch.Tensor, diag: torch.Tensor, tol: float,
              maxiter: int) -> tuple[torch.Tensor, int]:
    """``jax.scipy.sparse.linalg.cg(matvec, b, tol=tol, maxiter=maxiter,
    M=lambda r: r / diag)`` from x0 = 0, the whole array one vector (JAX's
    stop test ``|r|^2 > max(tol^2 |b|^2, atol^2)`` at its atol 0).  Returns
    the solution and the iterations it ran."""
    # tol squared in f32, as JAX squares it
    atol2 = torch.tensor(tol, dtype=b.dtype, device=b.device).square() * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = z = r / diag
    gamma = _vdot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(maxiter + 1):
        active = (_vdot(r, r) > atol2) & (k < maxiter)
        if i % _CG_CHECK == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = r_ / diag
        gamma_ = _vdot(r_, z_)
        p_ = z_ + (gamma_ / gamma) * p
        x, r = torch.where(active, x_, x), torch.where(active, r_, r)
        p, gamma = torch.where(active, p_, p), torch.where(active, gamma_, gamma)
        k = k + active.to(k.dtype)
    return x, int(k)


@torch.no_grad()
def solve_darcy(a: torch.Tensor, beta: float = 1.0, tol: float = 1e-8,
                maxiter: int = 4000) -> torch.Tensor:
    """(N, X, Y) solution of -div(a grad u) = beta, u|boundary = 0, on
    ``a``'s device."""
    n, nx, ny = a.shape
    h = 1.0 / nx
    matvec, diag = darcy_operator(a, h)
    rhs = torch.full_like(a, beta)
    u, _ = cg_jacobi(matvec, rhs, diag, tol, maxiter)
    return u.to(torch.float32)


def generate_darcy_file(
    out: str | Path,
    n_samples: int = 128,
    nx: int = 128,
    beta: float = 1.0,
    hi: float = 12.0,
    lo: float = 3.0,
    length_scale: float = 0.1,
    seed: int = 0,
    batch: int = 64,
    device=None,
) -> Path:
    """Write ``n_samples`` coefficient fields and solutions, ``batch`` at a
    time (one batch-coupled solve each), the fields drawn in turn from
    ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(int(seed))
    coords = (np.arange(nx, dtype=np.float32) + 0.5) / nx
    with h5io.h5py_module().File(out, "w") as f:
        dnu = f.create_dataset("nu", (n_samples, nx, nx), dtype="float32",
                               chunks=(1, nx, nx), compression="lzf")
        dts = f.create_dataset("tensor", (n_samples, 1, nx, nx), dtype="float32",
                               chunks=(1, 1, nx, nx), compression="lzf")
        f.create_dataset("x-coordinate", data=coords)
        f.create_dataset("y-coordinate", data=coords)
        f.attrs["beta"] = beta
        for b0 in range(0, n_samples, batch):
            nb = min(batch, n_samples - b0)
            a = sample_coefficient(gen, nb, nx, nx, hi=hi, lo=lo, length_scale=length_scale,
                                   device=dev)
            u = solve_darcy(a, beta=beta)
            dnu[b0 : b0 + nb] = a.cpu().numpy()
            dts[b0 : b0 + nb] = u.cpu().numpy()[:, None]
    return out


def load_pdebench_darcy(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """PDEBench Darcy file -> (a (N,X,Y), u (N,X,Y)) float32, through h5py
    or the port's HDF5 subset (chunked LZF or deflate files too)."""
    with h5io.h5py_module().File(path, "r") as f:
        a = np.asarray(f["nu"], dtype=np.float32)
        u = np.asarray(f["tensor"], dtype=np.float32)
    if u.ndim == 4:
        u = u[:, 0]
    return a, u


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="data/2D_DarcyFlow_beta1.0.h5")
    p.add_argument("--nsample", type=int, default=128)
    p.add_argument("--xdim", type=int, default=128)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--hi", type=float, default=12.0)
    p.add_argument("--lo", type=float, default=3.0)
    p.add_argument("--length-scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    path = generate_darcy_file(
        a.out, n_samples=a.nsample, nx=a.xdim, beta=a.beta, hi=a.hi, lo=a.lo,
        length_scale=a.length_scale, seed=a.seed, batch=a.batch, device=a.device,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
