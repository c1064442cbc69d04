"""2D incompressible Navier-Stokes simulator (port of
``sciml_pde_tpu/sim/ns_incomp_2d.py``; reference phiflow pipeline
``pdebench/data_gen/src/sim_ns_incomp_2d.py:34-341``, production config
``data_gen/configs/ns_incomp.yaml``).

Noise-initialised density ("particles", centred grid) and velocity
(staggered MAC grid) in a closed unit box, a random smooth force field,
and per step

    semi-Lagrangian advection -> diffusion
    -> velocity += DT * particles * force -> pressure projection
    -> particle advection

storing every ``frame_int``-th frame, batched over ``n_batch``
trajectories.  Every function takes leading batch dims where JAX vmaps.
The momentum steps loop on the device with no host sync until frames are
fetched; the DCT pressure solve is two f32 matmuls per axis.  The CG solve
is a host loop that keeps JAX's stop rules per trajectory (converged,
diverging past 1e4 x the best residual, or the iteration cap) and its
best-iterate tracking; it reads one flag from the device every 8
iterations.  The simulator's own products (the DCT factors, the
``diffusion_mode="exact"`` propagators) run in full f32 whatever
PyTorch's matmul precision is set to, which is restored afterwards.

Randomness: ``init_state`` draws from an explicit ``torch.Generator``
(``sim/grf.py``).  The port cannot reproduce JAX's PRNG bits, so parity
with JAX is held from the same initial state (JAX's ``init_state``
output fed to the port).

Grid layout (MAC):
  p, particles: (nx, ny) cell centres
  u: (nx+1, ny) x-normal faces;  v: (nx, ny+1) y-normal faces
  closed box: u[0]=u[-1]=0, v[:,0]=v[:,-1]=0  (velocity extrapolation ZERO)
  particles sample with edge clamping          (extrapolation BOUNDARY)
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.sim.grf import spectral_noise


@dataclasses.dataclass(frozen=True)
class NSIncompConfig:
    """Defaults = the production dataset config (ns_incomp.yaml)."""

    grid_size: tuple[int, int] = (256, 256)
    domain_size: tuple[float, float] = (1.0, 1.0)
    nu: float = 0.05
    dt: float = 5e-5
    n_steps: int = 100_000
    frame_int: int = 100
    n_batch: int = 4
    scale: float = 0.15
    smoothness: float = 3.0
    force_scale: float = 0.4
    force_smoothness: float = 1.0
    cg_tol: float = 1e-3
    cg_max_iter: int = 1000
    pressure_solver: str = "dct"  # dct (direct, exact) | cg (reference-like)
    # explicit = the reference's forward-Euler diffusion (dt-limited);
    # exact = expm of the same stencil via dense propagators (no dt limit)
    diffusion_mode: str = "explicit"
    # decomposition knobs for the "basic physics form" aux datasets
    enable_advection: bool = True
    enable_diffusion: bool = True
    enable_force: bool = True
    enable_projection: bool = True

    @property
    def dx(self) -> float:
        return self.domain_size[0] / self.grid_size[0]

    @property
    def dy(self) -> float:
        return self.domain_size[1] / self.grid_size[1]

    @property
    def n_frames(self) -> int:
        return (self.n_steps - 1) // self.frame_int + 1


@contextlib.contextmanager
def full_f32():
    """f32 matmuls without TF32 for the block, whatever the caller set;
    the caller's setting comes back afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# --------------------------------------------------------------------------
# staggered-grid helpers (leading dims are batch dims)
# --------------------------------------------------------------------------


def _u_positions(nx, ny, device=None):
    """Face-centre coordinates in cell units: u at (i, j+0.5)."""
    xi = torch.arange(nx + 1, dtype=torch.float32, device=device)
    yj = torch.arange(ny, dtype=torch.float32, device=device) + 0.5
    return xi[:, None], yj[None, :]


def _v_positions(nx, ny, device=None):
    xi = torch.arange(nx, dtype=torch.float32, device=device) + 0.5
    yj = torch.arange(ny + 1, dtype=torch.float32, device=device)
    return xi[:, None], yj[None, :]


def _c_positions(nx, ny, device=None):
    xi = torch.arange(nx, dtype=torch.float32, device=device) + 0.5
    yj = torch.arange(ny, dtype=torch.float32, device=device) + 0.5
    return xi[:, None], yj[None, :]


def bilinear(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor, zero_outside: bool):
    """Sample ``field`` (..., nx, ny), defined on integer lattice points, at
    (x, y), which broadcast to (nx', ny') or (..., nx', ny').

    zero_outside=True  -> value 0 beyond the lattice (extrapolation ZERO)
    zero_outside=False -> clamp to edge (extrapolation BOUNDARY)

    JAX's formula term for term: the floors of the positions pick the cell,
    so a position formed in another order could land in the next cell.
    """
    nx, ny = field.shape[-2:]
    batch = field.shape[:-2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    out_shape = torch.broadcast_shapes(batch + (1, 1), x.shape, y.shape)
    # the four corners (x0 + a, y0 + b) in one gather: index (a, b, ...)
    # moved behind the batch dims
    x0i, y0i = x0i.expand(out_shape), y0i.expand(out_shape)
    xs = torch.stack([x0i, x0i + 1])[:, None]
    ys = torch.stack([y0i, y0i + 1])[None, :]
    nb = len(batch)
    perm = (*range(2, 2 + nb), 0, 1, 2 + nb, 3 + nb)
    idx = (torch.clamp(xs, 0, nx - 1) * ny + torch.clamp(ys, 0, ny - 1))
    idx = idx.expand(2, 2, *out_shape).permute(perm).reshape(*batch, -1)
    vals = torch.gather(field.reshape(*batch, nx * ny), -1, idx)
    vals = vals.reshape(*batch, 2, 2, *out_shape[-2:])
    if zero_outside:
        inside = (xs >= 0) & (xs <= nx - 1) & (ys >= 0) & (ys <= ny - 1)
        vals = torch.where(inside.expand(2, 2, *out_shape).permute(perm), vals, 0.0)
    v00, v01 = vals[..., 0, 0, :, :], vals[..., 0, 1, :, :]
    v10, v11 = vals[..., 1, 0, :, :], vals[..., 1, 1, :, :]
    return (
        v00 * (1 - tx) * (1 - ty)
        + v10 * tx * (1 - ty)
        + v01 * (1 - tx) * ty
        + v11 * tx * ty
    )


def _apply_wall_bc(u: torch.Tensor, v: torch.Tensor):
    """Zero normal velocity at the box walls."""
    u = u.clone()
    v = v.clone()
    u[..., 0, :] = 0.0
    u[..., -1, :] = 0.0
    v[..., :, 0] = 0.0
    v[..., :, -1] = 0.0
    return u, v


def velocity_at(u, v, x, y):
    """Full velocity (in cell units per unit time) at arbitrary points.

    u lattice point (i, j) sits at (i, j+0.5); v point (i, j) at (i+0.5, j).
    """
    us = bilinear(u, x, y - 0.5, zero_outside=True)
    vs = bilinear(v, x - 0.5, y, zero_outside=True)
    return us, vs


def advect_staggered(u, v, dt_cells):
    """Semi-Lagrangian advection of the staggered velocity by itself.

    dt_cells: dt expressed so that u*dt is a displacement in cell units
    (u is stored in physical units; displacement = u*dt/dx).
    """
    nx, ny = u.shape[-2] - 1, v.shape[-1] - 1
    dtu, dtv = dt_cells

    ux, uy = _u_positions(nx, ny, u.device)
    uu, uv = velocity_at(u, v, ux, uy)
    bx, by = ux - dtu * uu, uy - dtv * uv
    u_new = bilinear(u, bx, by - 0.5, zero_outside=True)

    vx, vy = _v_positions(nx, ny, u.device)
    vu, vv = velocity_at(u, v, vx, vy)
    bx, by = vx - dtu * vu, vy - dtv * vv
    v_new = bilinear(v, bx - 0.5, by, zero_outside=True)
    return _apply_wall_bc(u_new, v_new)


def advect_centered(c, u, v, dt_cells):
    """Semi-Lagrangian advection of a centred field (clamped sampling)."""
    nx, ny = c.shape[-2:]
    dtu, dtv = dt_cells
    cx, cy = _c_positions(nx, ny, c.device)
    cu, cv = velocity_at(u, v, cx, cy)
    bx, by = cx - dtu * cu, cy - dtv * cv
    return bilinear(c, bx - 0.5, by - 0.5, zero_outside=False)


def _pad_x(a, edge: bool):
    lo, hi = (a[..., :1, :], a[..., -1:, :]) if edge else (
        torch.zeros_like(a[..., :1, :]), torch.zeros_like(a[..., -1:, :]))
    return torch.cat([lo, a, hi], dim=-2)


def _pad_y(a, edge: bool):
    lo, hi = (a[..., :, :1], a[..., :, -1:]) if edge else (
        torch.zeros_like(a[..., :, :1]), torch.zeros_like(a[..., :, -1:]))
    return torch.cat([lo, a, hi], dim=-1)


def diffuse_explicit_u(u, nu_dt_dx2, nu_dt_dy2):
    """Explicit diffusion of a face field; Dirichlet-0 beyond walls in the
    normal direction, Neumann (edge) tangentially, matching a ZERO velocity
    extrapolation."""
    px = _pad_x(u, edge=False)
    py = _pad_y(u, edge=True)
    lap = (px[..., 2:, :] - 2 * u + px[..., :-2, :]) * nu_dt_dx2 + (
        py[..., :, 2:] - 2 * u + py[..., :, :-2]
    ) * nu_dt_dy2
    return u + lap


def diffuse_explicit_v(v, nu_dt_dx2, nu_dt_dy2):
    px = _pad_x(v, edge=True)
    py = _pad_y(v, edge=False)
    lap = (px[..., 2:, :] - 2 * v + px[..., :-2, :]) * nu_dt_dx2 + (
        py[..., :, 2:] - 2 * v + py[..., :, :-2]
    ) * nu_dt_dy2
    return v + lap


@functools.lru_cache(maxsize=64)
def _diffusion_propagator(n: int, s: float, bc: str) -> np.ndarray:
    """Exact one-step diffusion propagator exp(s*L) for the same discrete
    1D Laplacian L the explicit kernels use (s = nu*dt/dh^2).

    bc='dirichlet': zero beyond the walls (the face-normal direction);
    bc='neumann':   edge/ghost-copy (the tangential direction).  Both L are
    symmetric, so expm comes from one eigh: a dense (n, n) matrix applied
    as a matmul, exact in time for the spatial stencil (no explicit
    stability limit on dt)."""
    L = np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    if bc == "neumann":
        L[0, 0] = -1.0
        L[-1, -1] = -1.0
    lam, vec = np.linalg.eigh(L)
    return (vec * np.exp(s * lam)) @ vec.T


def _propagator(n: int, s: float, bc: str, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_diffusion_propagator(n, float(s), bc), dtype=like.dtype,
                           device=like.device)


def diffuse_exact_u(u, nu_dt_dx2, nu_dt_dy2):
    tx = _propagator(u.shape[-2], nu_dt_dx2, "dirichlet", u)
    ty = _propagator(u.shape[-1], nu_dt_dy2, "neumann", u)
    with full_f32():
        return tx @ u @ ty.T


def diffuse_exact_v(v, nu_dt_dx2, nu_dt_dy2):
    tx = _propagator(v.shape[-2], nu_dt_dx2, "neumann", v)
    ty = _propagator(v.shape[-1], nu_dt_dy2, "dirichlet", v)
    with full_f32():
        return tx @ v @ ty.T


def divergence(u, v, dx, dy):
    return (u[..., 1:, :] - u[..., :-1, :]) / dx + (v[..., :, 1:] - v[..., :, :-1]) / dy


def _lap_neumann(p, dx, dy):
    """Pressure Laplacian with Neumann BC (closed box)."""
    px = _pad_x(p, edge=True)
    py = _pad_y(p, edge=True)
    return ((px[..., 2:, :] - 2 * p + px[..., :-2, :]) / dx**2
            + (py[..., :, 2:] - 2 * p + py[..., :, :-2]) / dy**2)


@functools.lru_cache(maxsize=32)
def _dct2_factors(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C (n, n): p_hat = C @ p, p = C.T @ p_hat.

    The cell-centred Neumann (edge-padded) Laplacian diagonalizes exactly in
    this basis with per-axis eigenvalues (2 cos(pi k / n) - 2)."""
    k = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    c = np.cos(np.pi * (x + 0.5) * k / n) * np.sqrt(2.0 / n)
    c[0] *= 1.0 / np.sqrt(2.0)
    return c.astype(np.float32)


def solve_pressure_dct(div, dx, dy):
    """Direct Poisson solve of lap(p) = div with Neumann BCs on (..., nx,
    ny): the DCT along each axis as an f32 matmul (full f32, as JAX's
    ``Precision.HIGHEST``), an elementwise eigenvalue division, and the
    inverse.  The nullspace (constant mode) is pinned to zero."""
    nx, ny = div.shape[-2:]
    cx = torch.as_tensor(_dct2_factors(nx), device=div.device)
    cy = torch.as_tensor(_dct2_factors(ny), device=div.device)
    lam_x = (2.0 * np.cos(np.pi * np.arange(nx) / nx) - 2.0) / dx**2
    lam_y = (2.0 * np.cos(np.pi * np.arange(ny) / ny) - 2.0) / dy**2
    lam = torch.as_tensor(lam_x[:, None] + lam_y[None, :], dtype=torch.float32,
                          device=div.device)
    with full_f32():
        dhat = cx @ div @ cy.T
        phat = torch.where(lam != 0.0, dhat / torch.where(lam != 0.0, lam, 1.0), 0.0)
        return cx.T @ phat @ cy


def _vdot(a, b):
    return (a * b).sum(dim=(-2, -1))


_CG_CHECK = 8  # CG iterations between host reads of the stop flag


def solve_pressure_cg(div, dx, dy, tol, max_iter):
    """Matrix-free CG for lap(p) = div with Neumann BCs on (..., nx, ny).

    Relative-tolerance stop (reference Solve('CG-adaptive', 1e-3, 0)).  The
    Neumann operator is singular (constant nullspace); the rhs is projected
    to mean zero, which makes the system compatible.  Past the f32 floor
    the singular system makes CG diverge again, so each trajectory keeps
    its best iterate and stops on convergence, on a residual 1e4 x its
    best, or at ``max_iter``; a stopped trajectory keeps its state while
    the others go on.  The stop rules are evaluated on the device every
    iteration, and the host reads whether any trajectory goes on every
    ``_CG_CHECK`` iterations, so the loop runs ahead of the card."""
    # CG needs a positive-(semi)definite operator; the Laplacian is negative
    # semidefinite, so solve (-lap) p = -(div - mean) instead
    b = -(div - div.mean(dim=(-2, -1), keepdim=True))
    bnorm = torch.sqrt(_vdot(b, b)) + 1e-30

    def A(p):
        return -_lap_neumann(p, dx, dy)

    p = torch.zeros_like(b)
    r, d = b, b
    rs = _vdot(r, r)
    p_best, rs_best = p, rs
    it = torch.zeros(rs.shape, dtype=torch.int64, device=div.device)

    def expand(m):
        return m[..., None, None]

    for k in itertools.count():
        converged = torch.sqrt(rs_best) <= tol * bnorm
        diverging = rs > 1e4 * rs_best
        active = (~converged) & (~diverging) & (it < max_iter)
        # the host reads the flag every _CG_CHECK iterations; in between, a
        # stopped trajectory's state is kept by the masks below
        if k % _CG_CHECK == 0 and not bool(active.any()):
            break
        Ad = A(d)
        alpha = rs / (_vdot(d, Ad) + 1e-30)
        p_n = p + expand(alpha) * d
        r_n = r - expand(alpha) * Ad
        rs_new = _vdot(r_n, r_n)
        d_n = r_n + expand(rs_new / (rs + 1e-30)) * d
        better = rs_new < rs_best
        pb_n = torch.where(expand(better), p_n, p_best)
        rsb_n = torch.where(better, rs_new, rs_best)
        a2 = expand(active)
        p, r, d = torch.where(a2, p_n, p), torch.where(a2, r_n, r), torch.where(a2, d_n, d)
        rs = torch.where(active, rs_new, rs)
        p_best = torch.where(a2, pb_n, p_best)
        rs_best = torch.where(active, rsb_n, rs_best)
        it = it + active.to(it.dtype)
    return p_best - p_best.mean(dim=(-2, -1), keepdim=True)


def project(u, v, dx, dy, tol, max_iter, method: str = "dct"):
    """Make the staggered velocity divergence-free.

    method='dct' (default): exact direct solve via DCT diagonalization.
    method='cg': the reference-equivalent iterative solve."""
    div = divergence(u, v, dx, dy)
    if method == "dct":
        p = solve_pressure_dct(div, dx, dy)
    else:
        p = solve_pressure_cg(div, dx, dy, tol, max_iter)
    u = u.clone()
    v = v.clone()
    u[..., 1:-1, :] += -(p[..., 1:, :] - p[..., :-1, :]) / dx
    v[..., :, 1:-1] += -(p[..., :, 1:] - p[..., :, :-1]) / dy
    return _apply_wall_bc(u, v)


def interp_center_to_u(c):
    """Centred field -> x-face positions (edge clamp at walls)."""
    mid = 0.5 * (c[..., 1:, :] + c[..., :-1, :])
    return torch.cat([c[..., :1, :], mid, c[..., -1:, :]], dim=-2)


def interp_center_to_v(c):
    mid = 0.5 * (c[..., :, 1:] + c[..., :, :-1])
    return torch.cat([c[..., :, :1], mid, c[..., :, -1:]], dim=-1)


def staggered_to_centered(u, v):
    """Resample MAC velocity to cell centres: (..., nx, ny, 2), the stored
    layout (reference data_io.to_centre_grid / to_ndarray)."""
    uc = 0.5 * (u[..., 1:, :] + u[..., :-1, :])
    vc = 0.5 * (v[..., :, 1:] + v[..., :, :-1])
    return torch.stack([uc, vc], dim=-1)


# --------------------------------------------------------------------------
# full simulation
# --------------------------------------------------------------------------


def momentum_step(u, v, c, fu, fv, cfg: NSIncompConfig):
    """One Cauchy-momentum step (reference sim_ns_incomp_2d.py:146-181).

    The enable_* flags select the decomposed basic forms (convection-only,
    diffusion-only, no-pressure aux datasets)."""
    dt_cells = (cfg.dt / cfg.dx, cfg.dt / cfg.dy)
    if cfg.enable_advection:
        u, v = advect_staggered(u, v, dt_cells)
    if cfg.enable_diffusion:
        sx, sy = cfg.nu * cfg.dt / cfg.dx**2, cfg.nu * cfg.dt / cfg.dy**2
        if cfg.diffusion_mode == "exact":
            u = diffuse_exact_u(u, sx, sy)
            v = diffuse_exact_v(v, sx, sy)
        else:
            u = diffuse_explicit_u(u, sx, sy)
            v = diffuse_explicit_v(v, sx, sy)
    if cfg.enable_force:
        # external force, modulated by the local density (reference :170)
        u = u + cfg.dt * interp_center_to_u(c) * fu
        v = v + cfg.dt * interp_center_to_v(c) * fv
    u, v = _apply_wall_bc(u, v)
    if cfg.enable_projection:
        u, v = project(u, v, cfg.dx, cfg.dy, cfg.cg_tol, cfg.cg_max_iter,
                       method=cfg.pressure_solver)
    c = advect_centered(c, u, v, dt_cells)
    return u, v, c


def init_state(generator: torch.Generator, cfg: NSIncompConfig, device=None):
    """Noise-initialised state (u, v, c, fu, fv) for one trajectory, drawn
    from ``generator`` in that order (phiflow Noise parity in distribution:
    smooth power-law fields), on ``device``."""
    dev = resolve_device(device)
    nx, ny = cfg.grid_size
    c = spectral_noise(generator, (nx, ny), cfg.scale, cfg.smoothness, device=dev)
    u = spectral_noise(generator, (nx + 1, ny), cfg.scale, cfg.smoothness, device=dev)
    v = spectral_noise(generator, (nx, ny + 1), cfg.scale, cfg.smoothness, device=dev)
    fu = spectral_noise(generator, (nx + 1, ny), cfg.force_scale, cfg.force_smoothness,
                        device=dev)
    fv = spectral_noise(generator, (nx, ny + 1), cfg.force_scale, cfg.force_smoothness,
                        device=dev)
    u, v = _apply_wall_bc(u, v)
    return u, v, c, fu, fv


def _frames(carry, fu, fv, cfg: NSIncompConfig, n_frames: int):
    """``n_frames`` stored frames from ``carry`` = (u, v, c), each after
    ``frame_int`` momentum steps: the carry after them, velocity (n_frames,
    ..., nx, ny, 2) and particles (n_frames, ..., nx, ny, 1)."""
    u, v, c = carry
    vel, par = [], []
    for _ in range(n_frames):
        for _ in range(cfg.frame_int):
            u, v, c = momentum_step(u, v, c, fu, fv, cfg)
        vel.append(staggered_to_centered(u, v))
        par.append(c[..., None])
    if not vel:
        return (u, v, c), None, None
    return (u, v, c), torch.stack(vel), torch.stack(par)


@torch.no_grad()
def simulate_ns_frames(state, cfg: NSIncompConfig):
    """Run the full simulation from ``state`` = (u, v, c, fu, fv) (batched or
    single), returning the stored frames on the state's device: velocity
    (n_frames, ..., nx, ny, 2) and particles (n_frames, ..., nx, ny, 1),
    the initial frame included."""
    u, v, c, fu, fv = state
    _, vel, par = _frames((u, v, c), fu, fv, cfg, cfg.n_frames - 1)
    vel0 = staggered_to_centered(u, v)[None]
    par0 = c[..., None][None]
    if vel is None:
        return vel0, par0
    return torch.cat([vel0, vel], dim=0), torch.cat([par0, par], dim=0)


@torch.no_grad()
def _simulate_chunk(carry, fu, fv, cfg: NSIncompConfig, n_chunk_frames: int):
    """Advance ``n_chunk_frames`` stored frames of a batched carry; frames
    come back (B, F, ...), frame-major within each trajectory."""
    carry, vel, par = _frames(carry, fu, fv, cfg, n_chunk_frames)
    return carry, torch.movedim(vel, 0, 1), torch.movedim(par, 0, 1)


@torch.no_grad()
def simulate_ns_batch(seed: int, cfg: NSIncompConfig, frames_per_chunk: int = 0,
                      frame_callback=None, device=None):
    """Batched trajectories from ``torch.Generator().manual_seed(seed)``:
    returns (velocity (B,T,nx,ny,2), particles (B,T,nx,ny,1), force
    (B,nx,ny,2), t (B,T)) as numpy arrays, simulated on ``device``.

    ``frames_per_chunk`` > 0 fetches the frames every that many stored
    frames (bounding device memory for them); with
    ``frame_callback(vel_chunk, par_chunk)`` the frames stream to the caller
    (e.g. straight into HDF5) and are not accumulated, and the returned
    vel/par are None."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    parts = [init_state(gen, cfg, device=dev) for _ in range(cfg.n_batch)]
    u, v, c, fu, fv = (torch.stack(t) for t in zip(*parts))
    force = staggered_to_centered(fu, fv).cpu().numpy()
    ts = np.broadcast_to(
        (np.arange(cfg.n_frames) * cfg.frame_int * cfg.dt).astype(np.float32),
        (cfg.n_batch, cfg.n_frames),
    )

    if not frames_per_chunk:
        vel, par = simulate_ns_frames((u, v, c, fu, fv), cfg)
        return (torch.movedim(vel, 0, 1).cpu().numpy(), torch.movedim(par, 0, 1).cpu().numpy(),
                force, ts)

    carry = (u, v, c)
    vel0 = staggered_to_centered(u, v).cpu().numpy()
    par0 = c.cpu().numpy()[..., None]
    chunks_v, chunks_p = [vel0[:, None]], [par0[:, None]]
    if frame_callback is not None:
        frame_callback(vel0[:, None], par0[:, None])
        chunks_v, chunks_p = None, None
    remaining = cfg.n_frames - 1
    while remaining > 0:
        n = min(frames_per_chunk, remaining)
        carry, vel_c, par_c = _simulate_chunk(carry, fu, fv, cfg, n)
        if frame_callback is not None:
            frame_callback(vel_c.cpu().numpy(), par_c.cpu().numpy())
        else:
            chunks_v.append(vel_c.cpu().numpy())
            chunks_p.append(par_c.cpu().numpy())
        remaining -= n
    if frame_callback is not None:
        return None, None, force, ts
    return (
        np.concatenate(chunks_v, axis=1),
        np.concatenate(chunks_p, axis=1),
        force,
        ts,
    )
