"""3D buoyant smoke plume simulator (port of
``sciml_pde_tpu/sim/ns_plume_3d.py``; reference phiflow generator
``pdebench/data_gen/src/3d_ns_phiflow/generate_3D_plume.py:13-90``).

A sphere inflow at the bottom of a closed unit box, MacCormack smoke
advection, semi-Lagrangian velocity advection, explicit diffusion,
buoyancy ((fx, fy) jittered in U(-1e-4, 1e-4), fz = 5e-4, scaled by the
local smoke density) and a pressure projection (direct DCT solve, or CG
with rel tol 1e-3), 150 stored frames x 10 substeps at dt = 2e-4; outputs
trilinearly resampled to (50, 50, 89) with align_corners=True, the initial
frame dropped, and time linearly resampled back to 150 frames (reference
:50-62).

The reference draws its buoyancy jitter once per trajectory (its python
``random`` call is traced once), and so does this port, from an explicit
``torch.Generator``.  The port cannot reproduce JAX's PRNG bits, so parity
with JAX is held on JAX's own jitter (``simulate_plume_jitter``).

Every substep runs on the device with no host sync, except the CG solve,
a host loop that keeps JAX's stop rules (converged, diverging past 1e4 x
the best residual, or the iteration cap) and its best-iterate tracking,
and reads its flag from the device every 8 iterations.  On the card a DCT
frame is captured once as a CUDA graph and replayed, JAX's compiled scan's
counterpart.  The trilinear
gathers take JAX's formulas term for term (the floors of the backtraced
positions pick the cells), reading the 8 corners in one indexed gather
and summing them in JAX's order.  The DCT solve's products run in full
f32 whatever PyTorch's matmul precision is set to.

MAC staggered grid: u (nx+1, ny, nz), v (nx, ny+1, nz), w (nx, ny, nz+1),
smoke and pressure (nx, ny, nz) cell centres.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.sim.ns_incomp_2d import _CG_CHECK, _dct2_factors, full_f32


@dataclasses.dataclass(frozen=True)
class Plume3DConfig:
    res: tuple[int, int, int] = (50, 50, 89)
    dt: float = 2e-4
    viscosity: float = 1e-3
    n_frames: int = 150
    substeps: int = 10
    inflow_radius_frac: float = 0.1
    inflow_strength: float = 0.1
    buoyancy_z: float = 5e-4
    buoyancy_jitter: float = 1e-4
    cg_tol: float = 1e-3
    cg_max_iter: int = 400
    pressure_solver: str = "dct"  # dct (direct, exact) | cg
    out_res: tuple[int, int, int] = (50, 50, 89)
    out_frames: int = 150
    # decomposition / variant knobs (reference run_3D_NS.py target dirs
    # encode decomp/downsample/OOD dataset variants)
    enable_advection: bool = True
    enable_diffusion: bool = True
    enable_buoyancy: bool = True
    enable_projection: bool = True


# --------------------------------------------------------------------------
# trilinear sampling on a 3D lattice
# --------------------------------------------------------------------------

def trilinear(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
              zero_outside: bool) -> torch.Tensor:
    """Sample ``field`` (nx, ny, nz), defined on integer lattice points, at
    (x, y, z), which broadcast together.  zero_outside=True: 0 beyond the
    lattice; False: clamp to the edge.

    JAX's formula term for term: the floors pick the cell; each corner's
    weight is wx * wy * wz times its value, and the 8 terms are summed in
    JAX's order (x offset outermost).  The corners' indices, masks and
    weights are formed per axis (2 values each) and broadcast to the 8
    corners, which one indexed read gathers."""
    nx, ny, nz = field.shape
    shape = torch.broadcast_shapes(x.shape, y.shape, z.shape)
    nd = len(shape)

    def axis(c, n, k):
        """The fraction past the floor's weights (1 - t, t), and the two
        corners' clamped indices and inside masks, each (2, *c.shape) viewed
        to broadcast on corner axis ``k`` of (2, 2, 2, *shape)."""
        c = c.reshape((1,) * (nd - c.ndim) + tuple(c.shape))
        view = [1, 1, 1, *c.shape]
        view[k] = 2
        c0 = torch.floor(c)
        t = c - c0
        i = c0.to(torch.int64)
        i2 = torch.stack([i, i + 1])
        return (torch.stack([1 - t, t]).view(view), i2.clamp(0, n - 1).view(view),
                ((i2 >= 0) & (i2 <= n - 1)).view(view))

    wx, ix, mx = axis(x, nx, 0)
    wy, iy, my = axis(y, ny, 1)
    wz, iz, mz = axis(z, nz, 2)
    vals = field.reshape(-1)[ix * (ny * nz) + iy * nz + iz]
    if zero_outside:
        vals = torch.where(mx & my & mz, vals, 0.0)
    terms = (wx * wy * wz * vals).reshape(8, *shape)
    out = terms[0]
    for k in range(1, 8):
        out = out + terms[k]
    return out


@functools.lru_cache(maxsize=64)
def _axis_coords(n: int, face: bool, axis: int, device: torch.device) -> torch.Tensor:
    """Face (0..n) or centre (0.5..n-0.5) coordinates along ``axis``, shaped
    to broadcast over a 3D lattice."""
    c = torch.arange(n + 1 if face else n, dtype=torch.float32, device=device)
    if not face:
        c = c + 0.5
    shape = [1, 1, 1]
    shape[axis] = -1
    return c.view(shape)


def _positions(nx, ny, nz, face_axis, device):
    """The (x, y, z) of a lattice's points in cell units: faces along
    ``face_axis`` (None: cell centres), centres along the others."""
    return tuple(_axis_coords(n, a == face_axis, a, device)
                 for a, n in enumerate((nx, ny, nz)))


def velocity_at3(u, v, w, x, y, z):
    """MAC velocity sampled at points given in cell units.

    u lattice point (i,j,k) sits at (i, j+.5, k+.5); v at (i+.5, j, k+.5);
    w at (i+.5, j+.5, k)."""
    us = trilinear(u, x, y - 0.5, z - 0.5, True)
    vs = trilinear(v, x - 0.5, y, z - 0.5, True)
    ws = trilinear(w, x - 0.5, y - 0.5, z, True)
    return us, vs, ws


def _wall_bc3(u, v, w):
    u, v, w = u.clone(), v.clone(), w.clone()
    u[0] = 0.0
    u[-1] = 0.0
    v[:, 0] = 0.0
    v[:, -1] = 0.0
    w[:, :, 0] = 0.0
    w[:, :, -1] = 0.0
    return u, v, w


def advect_velocity3(u, v, w, dtc):
    nx, ny, nz = v.shape[0], u.shape[1], u.shape[2]

    def comp(field, pos, off):
        x, y, z = pos
        uu, vv, ww = velocity_at3(u, v, w, x, y, z)
        bx, by, bz = x - dtc[0] * uu, y - dtc[1] * vv, z - dtc[2] * ww
        return trilinear(field, bx - off[0], by - off[1], bz - off[2], True)

    un = comp(u, _positions(nx, ny, nz, 0, u.device), (0.0, 0.5, 0.5))
    vn = comp(v, _positions(nx, ny, nz, 1, u.device), (0.5, 0.0, 0.5))
    wn = comp(w, _positions(nx, ny, nz, 2, u.device), (0.5, 0.5, 0.0))
    return _wall_bc3(un, vn, wn)


def _sl_smoke(c, u, v, w, dtc, sign=1.0, vel=None):
    """Semi-Lagrangian step of the centred smoke; ``vel``, the velocity at
    the cell centres, when the caller has it."""
    nx, ny, nz = c.shape
    x, y, z = _positions(nx, ny, nz, None, c.device)
    uu, vv, ww = velocity_at3(u, v, w, x, y, z) if vel is None else vel
    bx = x - sign * dtc[0] * uu
    by = y - sign * dtc[1] * vv
    bz = z - sign * dtc[2] * ww
    return trilinear(c, bx - 0.5, by - 0.5, bz - 0.5, False)


def _pad_edge(a: torch.Tensor, ax: int) -> torch.Tensor:
    n = a.shape[ax]
    return torch.cat([a.narrow(ax, 0, 1), a, a.narrow(ax, n - 1, 1)], dim=ax)


def _pad_zero(a: torch.Tensor, ax: int) -> torch.Tensor:
    z = torch.zeros_like(a.narrow(ax, 0, 1))
    return torch.cat([z, a, z], dim=ax)


def maccormack_smoke(c, u, v, w, dtc):
    """MacCormack advection with local min/max limiting (phiflow
    advect.mac_cormack behaviour).  The centre velocity of the forward and
    backward steps is sampled once."""
    nx, ny, nz = c.shape
    vel = velocity_at3(u, v, w, *_positions(nx, ny, nz, None, c.device))
    fwd = _sl_smoke(c, u, v, w, dtc, 1.0, vel)
    back = _sl_smoke(fwd, u, v, w, dtc, -1.0, vel)
    corrected = fwd + 0.5 * (c - back)
    # limit to the neighbourhood extrema of the field before the step
    p = _pad_edge(_pad_edge(_pad_edge(c, 0), 1), 2)
    stack = torch.stack([
        p[1:-1, 1:-1, 1:-1], p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1],
        p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1],
        p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:],
    ])
    lo, hi = stack.amin(0), stack.amax(0)
    return torch.minimum(torch.maximum(corrected, lo), hi)


def diffuse3(f, coef, zero_axes):
    """Explicit diffusion; Dirichlet-0 across the ``zero_axes`` walls
    (normal direction of a face field), Neumann elsewhere."""
    lap = None
    for ax in range(3):
        p = _pad_zero(f, ax) if ax in zero_axes else _pad_edge(f, ax)
        n = p.shape[ax]
        term = (p.narrow(ax, 2, n - 2) - 2 * f + p.narrow(ax, 0, n - 2)) * coef[ax]
        lap = term if lap is None else lap + term
    return f + lap


def divergence3(u, v, w, d):
    return (
        (u[1:] - u[:-1]) / d[0]
        + (v[:, 1:] - v[:, :-1]) / d[1]
        + (w[:, :, 1:] - w[:, :, :-1]) / d[2]
    )


def _lap_neumann3(p, d):
    out = None
    for ax in range(3):
        pad = _pad_edge(p, ax)
        n = pad.shape[ax]
        term = (pad.narrow(ax, 2, n - 2) - 2 * p + pad.narrow(ax, 0, n - 2)) / d[ax] ** 2
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=16)
def _dct3_operands(shape, d, device):
    """The orthonormal DCT-II factors of each axis and the Neumann
    Laplacian's eigenvalues (f32, as JAX's arrays), made once per grid."""
    cs = [torch.as_tensor(_dct2_factors(n), device=device) for n in shape]
    lams = [(2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0) / dd**2 for n, dd in zip(shape, d)]
    lam = lams[0][:, None, None] + lams[1][None, :, None] + lams[2][None, None, :]
    return cs, torch.as_tensor(lam, dtype=torch.float32, device=device)


def solve_pressure_dct3(div, d):
    """Direct Neumann Poisson solve via three-axis DCT-II diagonalization
    (see ``ns_incomp_2d.solve_pressure_dct``): six f32 contractions in full
    f32, JAX's ``Precision.HIGHEST``."""
    (c0, c1, c2), lam = _dct3_operands(tuple(div.shape), tuple(d), div.device)
    with full_f32():
        h = torch.einsum("ax,xyz->ayz", c0, div)
        h = torch.einsum("by,ayz->abz", c1, h)
        h = torch.einsum("cz,abz->abc", c2, h)
        h = torch.where(lam != 0.0, h / torch.where(lam != 0.0, lam, 1.0), 0.0)
        h = torch.einsum("ax,abc->xbc", c0, h)
        h = torch.einsum("by,xbc->xyc", c1, h)
        return torch.einsum("cz,xyc->xyz", c2, h)


def solve_pressure_cg3(div, d, tol, max_iter, x0=None):
    """Matrix-free CG for lap(p) = div with Neumann BCs, warm-started from
    ``x0``; keeps the best iterate and stops on convergence, on a residual
    1e4 x its best, or at ``max_iter`` (JAX's ``while_loop`` condition,
    evaluated on the device every iteration; the host reads it every
    ``_CG_CHECK`` iterations, and a stopped loop's state is kept by masks)."""
    b = -(div - div.mean())
    bnorm = torch.sqrt((b * b).sum()) + 1e-30

    def A(p):
        return -_lap_neumann3(p, d)

    p = torch.zeros_like(b) if x0 is None else x0 - x0.mean()
    r = b - A(p)
    dd = r
    rs = (r * r).sum()
    p_best, rs_best = p, rs
    it = torch.zeros((), dtype=torch.int64, device=div.device)
    for k in itertools.count():
        active = (torch.sqrt(rs_best) > tol * bnorm) & (rs <= 1e4 * rs_best) & (it < max_iter)
        if k % _CG_CHECK == 0 and not bool(active):
            break
        Ad = A(dd)
        alpha = rs / ((dd * Ad).sum() + 1e-30)
        p_n = p + alpha * dd
        r_n = r - alpha * Ad
        rs_new = (r_n * r_n).sum()
        d_n = r_n + (rs_new / (rs + 1e-30)) * dd
        better = rs_new < rs_best
        pb_n = torch.where(better, p_n, p_best)
        rsb_n = torch.where(better, rs_new, rs_best)
        p, r, dd = torch.where(active, p_n, p), torch.where(active, r_n, r), torch.where(
            active, d_n, dd)
        rs = torch.where(active, rs_new, rs)
        p_best = torch.where(active, pb_n, p_best)
        rs_best = torch.where(active, rsb_n, rs_best)
        it = it + active.to(it.dtype)
    return p_best - p_best.mean()


def project3(u, v, w, d, tol, max_iter, p_prev, method: str = "dct"):
    div = divergence3(u, v, w, d)
    if method == "dct":
        p = solve_pressure_dct3(div, d)
    else:
        p = solve_pressure_cg3(div, d, tol, max_iter, x0=p_prev)
    u, v, w = u.clone(), v.clone(), w.clone()
    u[1:-1] += -(p[1:] - p[:-1]) / d[0]
    v[:, 1:-1] += -(p[:, 1:] - p[:, :-1]) / d[1]
    w[:, :, 1:-1] += -(p[:, :, 1:] - p[:, :, :-1]) / d[2]
    return (*_wall_bc3(u, v, w), p)


def _center_to_face(c, ax):
    n = c.shape[ax]
    mid = 0.5 * (c.narrow(ax, 1, n - 1) + c.narrow(ax, 0, n - 1))
    return torch.cat([c.narrow(ax, 0, 1), mid, c.narrow(ax, n - 1, 1)], dim=ax)


def inflow_field(cfg: Plume3DConfig) -> np.ndarray:
    """Soft sphere indicator at the bottom-center of the unit box, scaled by
    ``inflow_strength`` (reference :26-29)."""
    nx, ny, nz = cfg.res
    dx = 1.0 / nx
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    z = (np.arange(nz) + 0.5) / nz
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    r = cfg.inflow_radius_frac
    dist = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + Z**2)
    # soft coverage: ~1 inside, smooth ramp over one cell at the surface
    soft = np.clip((r - dist) / dx + 0.5, 0.0, 1.0)
    return (cfg.inflow_strength * soft).astype(np.float32)


def substep(state, f_vec, inflow, cfg: Plume3DConfig):
    """One substep of ``state`` = (u, v, w, smoke, pressure)."""
    u, v, w, smoke, pressure = state
    nx, ny, nz = cfg.res
    d = (1.0 / nx, 1.0 / ny, 1.0 / nz)
    dtc = (cfg.dt / d[0], cfg.dt / d[1], cfg.dt / d[2])
    visc_coef = tuple(cfg.viscosity * cfg.dt / dd**2 for dd in d)
    smoke = maccormack_smoke(smoke, u, v, w, dtc) + inflow
    if cfg.enable_advection:
        u, v, w = advect_velocity3(u, v, w, dtc)
    if cfg.enable_diffusion:
        u = diffuse3(u, visc_coef, zero_axes=(0,))
        v = diffuse3(v, visc_coef, zero_axes=(1,))
        w = diffuse3(w, visc_coef, zero_axes=(2,))
    if cfg.enable_buoyancy:
        u = u + _center_to_face(smoke, 0) * f_vec[0]
        v = v + _center_to_face(smoke, 1) * f_vec[1]
        w = w + _center_to_face(smoke, 2) * f_vec[2]
    u, v, w = _wall_bc3(u, v, w)
    if cfg.enable_projection:
        u, v, w, pressure = project3(u, v, w, d, cfg.cg_tol, cfg.cg_max_iter, pressure,
                                     method=cfg.pressure_solver)
    return u, v, w, smoke, pressure


def centered_velocity(u, v, w) -> torch.Tensor:
    """The MAC velocity at the cell centres, (nx, ny, nz, 3)."""
    return torch.stack([0.5 * (u[1:] + u[:-1]), 0.5 * (v[:, 1:] + v[:, :-1]),
                        0.5 * (w[:, :, 1:] + w[:, :, :-1])], dim=-1)


def rest_state(cfg: Plume3DConfig, device=None):
    """The fluid at rest: (u, v, w, smoke, pressure), all zero."""
    dev = resolve_device(device)
    nx, ny, nz = cfg.res
    z = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    return z(nx + 1, ny, nz), z(nx, ny + 1, nz), z(nx, ny, nz + 1), z(nx, ny, nz), z(nx, ny, nz)


def buoyancy_jitter(generator: torch.Generator, cfg: Plume3DConfig) -> tuple[float, float]:
    """The trajectory's (fx, fy) buoyancy jitter, U(-j, j) each, drawn from
    ``generator``; f32 values."""
    j = cfg.buoyancy_jitter
    r = torch.rand(2, generator=generator, dtype=torch.float32, device=generator.device)
    jx, jy = (-j + r * (2 * j)).cpu().tolist()
    return float(np.float32(jx)), float(np.float32(jy))


def frame_fn(jitter: tuple[float, float], cfg: Plume3DConfig, device):
    """One stored frame as a function of the state: ``frame(u, v, w, smoke,
    pressure)`` runs ``cfg.substeps`` substeps with the buoyancy jitter (fx,
    fy) and returns the new state and its centred velocity."""
    inflow = torch.as_tensor(inflow_field(cfg), device=device)
    f_vec = (float(jitter[0]), float(jitter[1]), cfg.buoyancy_z)

    def frame(*st):
        for _ in range(cfg.substeps):
            st = substep(st, f_vec, inflow, cfg)
        return (*st, centered_velocity(*st[:3]))

    return frame


@torch.no_grad()
def simulate_plume_jitter(jitter: tuple[float, float], cfg: Plume3DConfig,
                          chunk_frames: int = 10, device=None):
    """``simulate_plume`` with the buoyancy jitter (fx, fy) given, from the
    fluid at rest.  Returns velocity (n_frames, nx,
    ny, nz, 3) centred and smoke (n_frames, nx, ny, nz) on the device, both
    EXCLUDING the initial rest frame.  ``chunk_frames`` is JAX's chunking
    of the frame loop; here the frames stay on the device.  On the card a
    DCT frame (its substeps and its centred velocity) is captured once as a
    CUDA graph and replayed (``utils/cuda_graph.py``); CG's flag reads are
    host syncs, so a CG frame runs op by op."""
    dev = resolve_device(device)
    state = rest_state(cfg, dev)
    frame = frame_fn(jitter, cfg, dev)
    if dev.type == "cuda" and cfg.pressure_solver == "dct" and cfg.n_frames > 1:
        from sciml_pde_torch.utils.cuda_graph import graphed

        frame = graphed(frame, *state)
    vels, smks = [], []
    for _ in range(cfg.n_frames):
        *state, vel = frame(*state)
        vels.append(vel.clone())
        smks.append(state[3].clone())
    return torch.stack(vels), torch.stack(smks)


def simulate_plume(generator: torch.Generator, cfg: Plume3DConfig, chunk_frames: int = 10,
                   device=None):
    """One trajectory from the rest state, its buoyancy jitter drawn once
    from ``generator``: velocity (n_frames, nx, ny, nz, 3) centred and smoke
    (n_frames, nx, ny, nz), both EXCLUDING the initial rest frame."""
    return simulate_plume_jitter(buoyancy_jitter(generator, cfg), cfg, chunk_frames, device)


def _linspace_f32(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in f32 as JAX forms it: stop * (i /
    (num - 1)), the endpoint exact."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = 0.0 * (1 - step) + torch.tensor(stop, dtype=torch.float32, device=device) * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32, device=device)])


def _resize_align_corners_1d(arr: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Linear resize with align_corners=True along one axis (torch
    F.interpolate semantics, reference :53-62), positions formed as JAX's."""
    n = arr.shape[axis]
    if n == new_len:
        return arr
    pos = _linspace_f32(n - 1.0, new_len, arr.device)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, 0, n - 1)
    t = (pos - lo).reshape([-1 if a == axis else 1 for a in range(arr.ndim)])
    a = torch.index_select(arr, axis, lo)
    b = torch.index_select(arr, axis, hi)
    return a * (1 - t) + b * t


@torch.no_grad()
def resample_outputs(vel, smk, cfg: Plume3DConfig):
    """Spatial trilinear resample to out_res, drop initial frame, time
    resample to out_frames — the reference's post-processing (:53-62).

    Returns v_data (X, Y, Z, T, 3) and s_data (T, X, Y, Z) as numpy, the
    on-disk layouts of v_trj_seed{i}.h5 / s_trj_seed{i}.h5."""
    for ax, target in zip((1, 2, 3), cfg.out_res):
        vel = _resize_align_corners_1d(vel, ax, target)
        smk = _resize_align_corners_1d(smk, ax, target)
    vel = _resize_align_corners_1d(vel[1:], 0, cfg.out_frames)
    smk = _resize_align_corners_1d(smk[1:], 0, cfg.out_frames)
    v_data = vel.permute(1, 2, 3, 0, 4)  # (X, Y, Z, T, 3)
    return v_data.cpu().numpy(), smk.cpu().numpy()


def generate_plume_files(path, seed: int, cfg: Plume3DConfig, suffix: str = "", device=None):
    """Write v_trj_seed{seed}{suffix}.h5 / s_trj_seed{seed}{suffix}.h5, each
    with one ``data`` dataset (LZF with shuffle, through h5py or, where it
    is missing, the port's HDF5 subset), from the trajectory of
    ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    vel, smk = simulate_plume(torch.Generator().manual_seed(int(seed)), cfg, device=dev)
    v_data, s_data = resample_outputs(vel, smk, cfg)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    h5py = h5io.h5py_module()
    with h5py.File(path / f"v_trj_seed{seed}{suffix}.h5", "w") as f:
        f.create_dataset("data", data=v_data, compression="lzf", shuffle=True)
    with h5py.File(path / f"s_trj_seed{seed}{suffix}.h5", "w") as f:
        f.create_dataset("data", data=s_data, compression="lzf", shuffle=True)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", required=True)
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--n-seeds", type=int, default=1)
    p.add_argument("--res", type=int, nargs=3, default=[50, 50, 89])
    p.add_argument("--dt", type=float, default=2e-4)
    p.add_argument("--viscosity", type=float, default=1e-3)
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--suffix", default="", help="e.g. _interp for primary files")
    p.add_argument(
        "--variant", default="full",
        choices=["full", "convection", "diffusion", "downsample", "ood"],
        help="decomposed basic forms / downsampled / out-of-distribution "
             "datasets (reference run_3D_NS.py target-dir variants)",
    )
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    variant_over = {
        "full": {},
        "convection": {"enable_diffusion": False, "enable_buoyancy": False},
        "diffusion": {"enable_advection": False, "enable_buoyancy": False,
                      "enable_projection": False},
        "downsample": {"out_res": tuple(s // 2 for s in a.res)},
        "ood": {"viscosity": a.viscosity * 10.0, "inflow_radius_frac": 0.15},
    }[a.variant]
    kwargs = dict(
        res=tuple(a.res), dt=a.dt, viscosity=a.viscosity, n_frames=a.frames,
        out_res=tuple(a.res), out_frames=a.frames,
    )
    kwargs.update(variant_over)
    cfg = Plume3DConfig(**kwargs)
    dev = resolve_device(a.device)
    for s in range(a.seed_start, a.seed_start + a.n_seeds):
        generate_plume_files(a.path, s, cfg, a.suffix, device=dev)
        print(f"seed {s} done", flush=True)


if __name__ == "__main__":
    main()
