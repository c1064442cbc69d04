"""2D compressible flow around an airfoil: the generator for the airfoil
point-cloud suite (port of ``sciml_pde_tpu/sim/airfoil_2d.py``).

The reference trains its irregular spatio-temporal OFormer on the
meshgraphnets airfoil dataset (``OFormer Model Comparison/airfoil/
dataset_new.py:550-640``): per-sample ``.npz`` files holding a FIXED
scattered node set (``pos``), integer ``node_type`` in {0: fluid,
2: airfoil surface, 4: open/far-field boundary}, triangle ``cells``, and
evolving ``dns`` / ``prs`` / ``vel`` node states at aerodynamic scales
(density ~1.2 kg/m^3, pressure ~1e5 Pa, speeds ~160 m/s — the loader's
``af_train_data_statistics.npz``).  The dataset itself is a proprietary
download, so the reference ships no generator; this module produces the
same protocol (npz keys, raw node-type codes, channel scales, statistics
file) from a real simulation.

Physics: 2D compressible Euler, finite-volume Rusanov (local
Lax-Friedrichs) fluxes with MUSCL/minmod reconstruction, SSP-RK2 in
time, Brinkman volume penalization for the solid NACA body (momentum and
energy relaxed toward a zero-velocity state inside the mask), and a
far-field sponge that relaxes toward free-stream to absorb outgoing
waves.  Each sample varies the free-stream Mach number, angle of attack
and NACA camber/thickness, drawn from ``np.random.default_rng(seed)`` as
JAX's are.

The solver state is a dense (4, H, W) conservative array advanced on the
card by stencil updates, JAX's expressions term for term (the minmod
limiter's branches flip on a one-ulp change of its inputs).  The geometry
(the NACA polyline, its inside mask by an even-odd crossing test —
matplotlib's, which the card's machine lacks — and distances) is numpy on
the host; nodes are sampled FEM-like and gathered by bilinear
interpolation from the saved frames on the card; ``scipy.spatial.Delaunay``
triangulates them.

  python -m sciml_pde_torch.sim.airfoil_2d --out data/airfoil --nsample 16

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device

GAMMA = 1.4
_CHUNK = 8192  # points a geometry pass takes at once (bounds its host memory)


# --------------------------------------------------------------------------
# NACA geometry
# --------------------------------------------------------------------------


def naca4_polyline(
    camber: float, camber_pos: float, thickness: float, n: int = 200
) -> np.ndarray:
    """Closed surface polyline of a NACA 4-digit airfoil, chord 1, nose at
    origin, trailing edge at (1, 0).  ``camber``/``thickness`` are chord
    fractions (e.g. 0.02 / 0.12 for NACA 2412), ``camber_pos`` in (0, 1)."""
    beta = np.linspace(0.0, np.pi, n)
    x = 0.5 * (1.0 - np.cos(beta))  # cosine spacing, fine at nose/tail
    yt = 5.0 * thickness * (
        0.2969 * np.sqrt(x)
        - 0.1260 * x
        - 0.3516 * x**2
        + 0.2843 * x**3
        - 0.1036 * x**4  # closed trailing edge variant
    )
    m, p = camber, max(camber_pos, 1e-6)
    yc = np.where(
        x < p,
        m / p**2 * (2 * p * x - x**2),
        m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x**2),
    )
    dyc = np.where(
        x < p, 2 * m / p**2 * (p - x), 2 * m / (1 - p) ** 2 * (p - x)
    )
    th = np.arctan(dyc)
    xu, yu = x - yt * np.sin(th), yc + yt * np.cos(th)
    xl, yl = x + yt * np.sin(th), yc - yt * np.cos(th)
    # upper surface nose->tail, then lower tail->nose (closed loop)
    pts = np.concatenate(
        [np.stack([xu, yu], 1), np.stack([xl, yl], 1)[::-1][1:-1]], axis=0
    )
    return pts.astype(np.float64)


def _point_segment_dist(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """min distance from points p (N,2) to segments a->b (M,2)."""
    ab = b - a  # (M,2)
    ap = p[:, None, :] - a[None]  # (N,M,2)
    denom = (ab**2).sum(-1)[None]  # (1,M)
    t = np.clip((ap * ab[None]).sum(-1) / np.maximum(denom, 1e-12), 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    return np.sqrt(((p[:, None, :] - closest) ** 2).sum(-1)).min(axis=1)


def contains_points(poly: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Even-odd test of points (N, 2) against the closed polygon ``poly``
    (M, 2): a point is inside where a ray along +x crosses an odd number of
    edges.  matplotlib's ``Path.contains_points`` test term for term (its
    crossing test of each edge (x0, y0) -> (x1, y1) against the point (tx,
    ty): the y's straddle, ``y0 >= ty`` differs from ``y1 >= ty``, and
    ``((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty)``),
    in float64, so points on or near an edge fall as they fall there.  A
    point whose y lies outside (min y, max y] straddles no edge and is
    skipped."""
    pts = np.asarray(pts, np.float64)
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(poly[:, 0], -1), np.roll(poly[:, 1], -1)
    out = np.zeros(len(pts), bool)
    band = np.flatnonzero((pts[:, 1] > y0.min()) & (pts[:, 1] <= y0.max()))
    for s in range(0, len(band), _CHUNK):
        idx = band[s:s + _CHUNK]
        tx, ty = pts[idx, 0:1], pts[idx, 1:2]
        f0, f1 = y0 >= ty, y1 >= ty
        cross = (f0 != f1) & (((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == f1)
        out[idx] = (np.count_nonzero(cross, axis=1) % 2) == 1
    return out


def airfoil_mask_and_distance(
    poly: np.ndarray, pts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(inside mask, unsigned distance to surface) for points (N, 2).  The
    distance is formed ``_CHUNK`` points at a time (each point's own minimum
    over the segments, so the chunks change no value)."""
    inside = contains_points(poly, pts)
    b = np.roll(poly, -1, axis=0)
    d = np.concatenate([_point_segment_dist(pts[s:s + _CHUNK], poly, b)
                        for s in range(0, len(pts), _CHUNK)]) if len(pts) else np.zeros(0)
    return inside, d


def place_airfoil(
    poly: np.ndarray, aoa_deg: float, chord: float = 1.0
) -> np.ndarray:
    """Rotate by -aoa (flow along +x), scale to chord, center at origin."""
    c, s = np.cos(np.deg2rad(-aoa_deg)), np.sin(np.deg2rad(-aoa_deg))
    rot = np.array([[c, -s], [s, c]])
    return (poly - np.array([0.4, 0.0])) @ rot.T * chord


# --------------------------------------------------------------------------
# compressible Euler FV solver
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AirfoilConfig:
    nx: int = 384
    ny: int = 384
    extent: float = 6.0  # domain [-extent, extent]^2, chord 1
    rho_inf: float = 1.204
    p_inf: float = 99_300.0
    mach: float = 0.47
    aoa_deg: float = 2.0
    camber: float = 0.02
    camber_pos: float = 0.4
    thickness: float = 0.12
    cfl: float = 0.35
    eta_penal: float = 8.0  # penalization rate multiplier (1/dt units)
    sponge_width: float = 1.2  # in length units from each edge
    sponge_rate: float = 40.0  # 1/s at the outer edge
    n_frames: int = 101
    frame_dt: float = 2.0e-3  # seconds between saved frames
    settle_time: float = 5.0e-2  # seconds discarded before frame 0

    @property
    def dx(self) -> float:
        return 2.0 * self.extent / self.nx

    @property
    def a_inf(self) -> float:
        return float(np.sqrt(GAMMA * self.p_inf / self.rho_inf))

    @property
    def v_inf(self) -> float:
        return self.mach * self.a_inf

    @property
    def dt(self) -> float:
        vmax = self.v_inf + 1.8 * self.a_inf
        return self.cfl * self.dx / vmax

    @property
    def settle_steps(self) -> int:
        """Steps of the settle phase before frame 0."""
        return int(round(self.settle_time / self.dt))

    @property
    def frame_steps(self) -> int:
        """Steps between stored frames."""
        return max(1, int(round(self.frame_dt / self.dt)))


def _primitive(U):
    rho = U[0]
    u = U[1] / rho
    v = U[2] / rho
    p = (GAMMA - 1.0) * (U[3] - 0.5 * rho * (u * u + v * v))
    return rho, u, v, p


def _flux_x(U):
    rho, u, v, p = _primitive(U)
    return torch.stack([rho * u, rho * u * u + p, rho * u * v, u * (U[3] + p)])


def _flux_y(U):
    rho, u, v, p = _primitive(U)
    return torch.stack([rho * v, rho * u * v, rho * v * v + p, v * (U[3] + p)])


def _wavespeed(U):
    rho, u, v, p = _primitive(U)
    a = torch.sqrt(GAMMA * torch.clamp_min(p, 1e-3) / rho)
    return torch.sqrt(u * u + v * v) + a


def _minmod(a, b):
    """JAX's expression term for term: its ``a * b > 0`` and ``|a| < |b|``
    tests pick the branch."""
    return torch.where(a * b > 0.0, torch.where(torch.abs(a) < torch.abs(b), a, b), 0.0)


def _edge_states(U, axis):
    """MUSCL/minmod left/right states at interior interfaces along axis."""
    d = torch.diff(U, dim=axis)
    n, m = U.shape[axis], d.shape[axis]
    slope = _minmod(d.narrow(axis, 0, m - 1), d.narrow(axis, 1, m - 1))  # cells 1..n-2
    # interface i+1/2 for i = 1..n-3 uses cells i (left) and i+1 (right)
    UL = U.narrow(axis, 1, n - 3) + 0.5 * slope.narrow(axis, 0, n - 3)
    UR = U.narrow(axis, 2, n - 3) - 0.5 * slope.narrow(axis, 1, n - 3)
    return UL, UR


def _rusanov(UL, UR, flux):
    lam = torch.maximum(_wavespeed(UL), _wavespeed(UR))[None]
    return 0.5 * (flux(UL) + flux(UR)) - 0.5 * lam * (UR - UL)


def _pad_edge2(U: torch.Tensor, k: int) -> torch.Tensor:
    """``U`` (C, H, W) with ``k`` edge copies on each side of H and W."""
    U = torch.cat([U[:, :1].expand(-1, k, -1), U, U[:, -1:].expand(-1, k, -1)], dim=1)
    return torch.cat([U[:, :, :1].expand(-1, -1, k), U, U[:, :, -1:].expand(-1, -1, k)], dim=2)


def make_step(cfg: AirfoilConfig, chi: torch.Tensor, sponge: torch.Tensor,
              U_inf: torch.Tensor):
    """One SSP-RK2 Euler step with penalization + sponge.

    chi: (H, W) solid mask in [0,1]; sponge: (H, W) relaxation rate (1/s);
    U_inf: (4,) free-stream conservative state; the step runs on their
    device.
    """
    dx = cfg.dx
    dt = cfg.dt

    def rhs(U):
        # pad with free-stream ghosts (sponge handles physics at edges)
        Ug = _pad_edge2(U, 2)
        # x-direction (axis 1 of padded array)
        UL, UR = _edge_states(Ug, 1)
        Fx = _rusanov(UL, UR, _flux_x)  # interfaces between padded cells
        dFx = (Fx[:, 1:, :] - Fx[:, :-1, :])[:, :, 2:-2] / dx
        UL, UR = _edge_states(Ug, 2)
        Fy = _rusanov(UL, UR, _flux_y)
        dFy = (Fy[:, :, 1:] - Fy[:, :, :-1])[:, 2:-2, :] / dx
        return -(dFx + dFy)

    # zero-velocity, free-stream-pressure target inside the body
    U_solid = torch.tensor([cfg.rho_inf, 0.0, 0.0, cfg.p_inf / (GAMMA - 1.0)],
                           dtype=torch.float32, device=chi.device)
    k_pen = cfg.eta_penal / dt  # fast relaxation inside the body
    # the relaxation's constants, formed once as JAX's step forms them
    rate = (k_pen * chi + sponge)[None]
    target = chi[None] * U_solid[:, None, None] + (1.0 - chi)[None] * U_inf[:, None, None]
    f = rate * dt

    def relax(U):
        # implicit (unconditionally stable) relaxation toward target
        return (U + f * target) / (1.0 + f)

    @torch.no_grad()
    def step(U):
        U1 = U + dt * rhs(U)
        U2 = 0.5 * (U + U1 + dt * rhs(U1))
        return relax(U2)

    return step


def freestream_state(cfg: AirfoilConfig) -> np.ndarray:
    u = cfg.v_inf
    E = cfg.p_inf / (GAMMA - 1.0) + 0.5 * cfg.rho_inf * u * u
    return np.array([cfg.rho_inf, cfg.rho_inf * u, 0.0, E], np.float32)


def setup(cfg: AirfoilConfig, smooth_cells: int = 2):
    """The grid (X, Y) and the solver's fields: the smoothed solid mask chi
    and the sponge rate, (nx, ny) float64 each (numpy, as JAX forms them)."""
    xs = np.linspace(-cfg.extent + cfg.dx / 2, cfg.extent - cfg.dx / 2, cfg.nx)
    ys = np.linspace(-cfg.extent + cfg.dx / 2, cfg.extent - cfg.dx / 2, cfg.ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], 1)

    poly = place_airfoil(
        naca4_polyline(cfg.camber, cfg.camber_pos, cfg.thickness), cfg.aoa_deg
    )
    inside, dist = airfoil_mask_and_distance(poly, pts)
    # smooth indicator over ~smooth_cells cells (stabilizes penalization)
    w = smooth_cells * cfg.dx
    chi = np.where(
        inside, 1.0, np.clip(1.0 - dist / w, 0.0, 1.0) ** 2
    ).reshape(cfg.nx, cfg.ny)

    edge = np.minimum.reduce(
        [X + cfg.extent, cfg.extent - X, Y + cfg.extent, cfg.extent - Y]
    )
    sponge = cfg.sponge_rate * np.clip(
        1.0 - edge / cfg.sponge_width, 0.0, 1.0
    ) ** 2
    return X, Y, chi, sponge


@torch.no_grad()
def simulate(cfg: AirfoilConfig, smooth_cells: int = 2, device=None):
    """Run the solve on ``device``; returns (frames, chi, grid_xy) as numpy.

    frames: (n_frames, 4, H, W) primitive fields [rho, u, v, p].  The steps
    run on the device with no host sync but each frame's fetch; on the card
    a frame's steps are captured once as a CUDA graph and replayed
    (``utils/cuda_graph.py``), the settle phase in as many frames' worth as
    it holds and its remainder op by op.
    """
    dev = resolve_device(device)
    X, Y, chi, sponge = setup(cfg, smooth_cells)
    U_inf = freestream_state(cfg)
    U0 = np.broadcast_to(U_inf[:, None, None], (4, cfg.nx, cfg.ny)).copy()
    # start from free-stream with the body switched on: the settle phase
    # washes the impulsive transient out through the sponge
    f32 = dict(dtype=torch.float32, device=dev)
    step = make_step(cfg, torch.as_tensor(chi, **f32), torch.as_tensor(sponge, **f32),
                     torch.as_tensor(U_inf, **f32))

    U = torch.as_tensor(U0, **f32)

    def advance(U):
        for _ in range(cfg.frame_steps):
            U = step(U)
        return (U,)

    if dev.type == "cuda":
        from sciml_pde_torch.utils.cuda_graph import graphed

        advance = graphed(advance, U)
    for _ in range(cfg.settle_steps // cfg.frame_steps):
        (U,) = advance(U)
    for _ in range(cfg.settle_steps % cfg.frame_steps):
        U = step(U)

    frames = np.zeros((cfg.n_frames, 4, cfg.nx, cfg.ny), np.float32)
    for f in range(cfg.n_frames):
        frames[f] = torch.stack(_primitive(U)).cpu().numpy()
        if f < cfg.n_frames - 1:
            (U,) = advance(U)
    grid = np.stack([X, Y], -1).astype(np.float32)
    return frames, chi.astype(np.float32), grid


# --------------------------------------------------------------------------
# FEM-like node sampling + npz export (reference protocol)
# --------------------------------------------------------------------------


def sample_nodes(
    cfg: AirfoilConfig,
    rng: np.random.Generator,
    n_interior: int = 1200,
    n_surface: int = 160,
    n_farfield: int = 80,
):
    """Scattered nodes: surface ring (raw type 2), far-field box (raw 4),
    interior fluid nodes refined toward the body and wake (raw 0)."""
    poly = place_airfoil(
        naca4_polyline(cfg.camber, cfg.camber_pos, cfg.thickness), cfg.aoa_deg
    )
    # surface nodes: resample the polyline uniformly by arc length, pushed
    # slightly outward so bilinear gathers read fluid-side states
    seg = np.roll(poly, -1, axis=0) - poly
    arclen = np.concatenate([[0.0], np.cumsum(np.sqrt((seg**2).sum(1)))])
    t = np.linspace(0, arclen[-1], n_surface, endpoint=False)
    idx = np.searchsorted(arclen, t, side="right") - 1
    frac = (t - arclen[idx]) / np.maximum(
        np.sqrt((seg[idx] ** 2).sum(1)), 1e-12
    )
    spts = poly[idx] + frac[:, None] * seg[idx]
    # polyline runs upper nose->tail then lower tail->nose (clockwise), so
    # the outward normal of segment (dx, dy) is (-dy, dx)
    normals = np.stack([-seg[idx][:, 1], seg[idx][:, 0]], 1)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    spts = spts + 3.0 * cfg.dx * normals  # offset outside the smoothed mask

    # far-field nodes on the inner edge of the sponge
    lim = cfg.extent - cfg.sponge_width
    per = n_farfield // 4
    lin = np.linspace(-lim, lim, per)
    fpts = np.concatenate(
        [
            np.stack([lin, np.full(per, -lim)], 1),
            np.stack([lin, np.full(per, lim)], 1),
            np.stack([np.full(per, -lim), lin], 1),
            np.stack([np.full(per, lim), lin], 1),
        ]
    )

    # interior nodes: rejection-sample with density ~ 1/(d + d0), plus a
    # wake strip behind the airfoil
    cand = rng.uniform(-lim, lim, size=(n_interior * 12, 2))
    inside, dist = airfoil_mask_and_distance(poly, cand)
    keep_p = 0.12 / (dist + 0.12)
    wake = (cand[:, 0] > 0.0) & (np.abs(cand[:, 1]) < 0.6)
    keep_p = np.where(wake, np.maximum(keep_p, 0.25), keep_p)
    ok = (~inside) & (dist > 3.5 * cfg.dx) & (rng.uniform(size=len(cand)) < keep_p)
    ipts = cand[ok][:n_interior]

    pos = np.concatenate([ipts, spts, fpts]).astype(np.float32)
    node_type = np.concatenate(
        [
            np.zeros(len(ipts), np.int32),
            np.full(len(spts), 2, np.int32),
            np.full(len(fpts), 4, np.int32),
        ]
    )
    return pos, node_type


def interpolate_frames(
    frames: np.ndarray, pos: np.ndarray, cfg: AirfoilConfig, device=None
) -> np.ndarray:
    """Bilinear gather of (T, 4, H, W) frames at scattered pos (N, 2) —
    batched over frames on ``device``. Returns (T, N, 4)."""
    gx = (pos[:, 0] + cfg.extent - cfg.dx / 2) / cfg.dx
    gy = (pos[:, 1] + cfg.extent - cfg.dx / 2) / cfg.dx
    x0 = np.clip(np.floor(gx).astype(np.int32), 0, cfg.nx - 2)
    y0 = np.clip(np.floor(gy).astype(np.int32), 0, cfg.ny - 2)
    fx = np.clip(gx - x0, 0.0, 1.0).astype(np.float32)
    fy = np.clip(gy - y0, 0.0, 1.0).astype(np.float32)

    dev = resolve_device(device)
    fr = torch.as_tensor(frames, device=dev)
    i0, j0 = (torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (x0, y0))
    fx, fy = (torch.as_tensor(a, device=dev) for a in (fx, fy))
    f00 = fr[:, :, i0, j0]
    f10 = fr[:, :, i0 + 1, j0]
    f01 = fr[:, :, i0, j0 + 1]
    f11 = fr[:, :, i0 + 1, j0 + 1]
    out = (f00 * (1 - fx) * (1 - fy) + f10 * fx * (1 - fy)
           + f01 * (1 - fx) * fy + f11 * fx * fy)
    return torch.movedim(out, 1, 2).cpu().numpy()  # (T, N, 4)


def generate_sample(seed: int, base: AirfoilConfig | None = None, device=None):
    """One airfoil trajectory with randomized Mach/AoA/shape; returns the
    npz dict in the reference's schema.  The shape, flow and nodes come from
    ``np.random.default_rng(seed)``, as JAX's do; the solve runs on
    ``device``."""
    rng = np.random.default_rng(seed)
    base = base or AirfoilConfig()
    cfg = dataclasses.replace(
        base,
        mach=float(rng.uniform(0.30, 0.62)),
        aoa_deg=float(rng.uniform(-10.0, 10.0)),
        camber=float(rng.uniform(0.0, 0.045)),
        camber_pos=float(rng.uniform(0.3, 0.5)),
        thickness=float(rng.uniform(0.09, 0.16)),
    )
    frames, _, _ = simulate(cfg, device=device)
    pos, node_type = sample_nodes(cfg, rng)
    states = interpolate_frames(frames, pos, cfg, device)  # (T, N, 4): rho,u,v,p

    from scipy.spatial import Delaunay

    cells = Delaunay(pos).simplices.astype(np.int32)
    T = cfg.n_frames
    return {
        "pos": np.repeat(pos[None], T, 0),
        "node_type": np.repeat(node_type[None, :, None], T, 0),
        "cells": np.repeat(cells[None], T, 0),
        "dns": states[..., 0:1],
        "vel": states[..., 1:3],
        "prs": states[..., 3:4],
        "meta": np.array(
            [cfg.mach, cfg.aoa_deg, cfg.camber, cfg.camber_pos, cfg.thickness],
            np.float32,
        ),
    }


def generate_dataset(
    out_dir: str,
    seeds: list[int],
    base: AirfoilConfig | None = None,
    verbose: bool = True,
    device=None,
):
    """Write one npz per seed + the loader's statistics npz."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    vel_all, prs_all, dns_all = [], [], []
    import time as _time

    for s in seeds:
        t0 = _time.time()
        d = generate_sample(s, base, dev)
        np.savez_compressed(out / f"airfoil_{s:04d}.npz", **d)
        vel_all.append(d["vel"])
        prs_all.append(d["prs"])
        dns_all.append(d["dns"])
        if verbose:
            print(
                f"seed {s}: {d['vel'].shape[1]} nodes, "
                f"{_time.time() - t0:.1f}s", flush=True,
            )
    vel = np.concatenate([v.reshape(-1, 2) for v in vel_all])
    prs = np.concatenate([p.ravel() for p in prs_all])
    dns = np.concatenate([x.ravel() for x in dns_all])
    pos_lim = (base or AirfoilConfig()).extent
    np.savez(
        out / "af_train_data_statistics.npz",
        dns_mean=dns.mean(), dns_std=dns.std(),
        prs_mean=prs.mean(), prs_std=prs.std(),
        vel_x_mean=vel[:, 0].mean(), vel_x_std=vel[:, 0].std(),
        vel_y_mean=vel[:, 1].mean(), vel_y_std=vel[:, 1].std(),
        pos_x_min=-pos_lim, pos_x_max=pos_lim,
        pos_y_min=-pos_lim, pos_y_max=pos_lim,
        x_len=2.0 * pos_lim, y_len=2.0 * pos_lim,
    )


def load_airfoil_dataset(data_dir: str, n_points: int | None = None):
    """Read generated npz files into the point-set training dict
    (fields (S,T,N,4) standardized per statistics, coords normalized to
    [0,1], mapped node types {0,1,2}) — the reference loader's
    use_normalized=True path (dataset_new.py:622-660)."""
    files = sorted(Path(data_dir).glob("airfoil_*.npz"))
    stats = np.load(Path(data_dir) / "af_train_data_statistics.npz")
    fields, coords, ntypes = [], [], []
    nmap = {0: 0, 2: 1, 4: 2}
    for f in files:
        d = np.load(f)
        vel, prs, dns = d["vel"], d["prs"], d["dns"]
        x = np.concatenate(
            [
                (vel[..., 0:1] - stats["vel_x_mean"]) / stats["vel_x_std"],
                (vel[..., 1:2] - stats["vel_y_mean"]) / stats["vel_y_std"],
                (prs - stats["prs_mean"]) / stats["prs_std"],
                (dns - stats["dns_mean"]) / stats["dns_std"],
            ],
            axis=-1,
        ).astype(np.float32)
        pos = d["pos"][0]
        pos01 = (pos - [stats["pos_x_min"], stats["pos_y_min"]]) / [
            stats["x_len"], stats["y_len"],
        ]
        nt = np.vectorize(nmap.get)(d["node_type"][0, :, 0]).astype(np.int32)
        if n_points is not None:
            sel = np.arange(min(n_points, x.shape[1]))
            x, pos01, nt = x[:, sel], pos01[sel], nt[sel]
        fields.append(x)
        coords.append(pos01.astype(np.float32))
        ntypes.append(nt)
    n_min = min(f.shape[1] for f in fields)
    fields = np.stack([f[:, :n_min] for f in fields])
    coords = np.stack([c[:n_min] for c in coords])
    ntypes = np.stack([t[:n_min] for t in ntypes])
    return dict(fields=fields, coords=coords, node_type=ntypes)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="data/airfoil")
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--nsample", type=int, default=16)
    p.add_argument("--nx", type=int, default=384)
    p.add_argument("--frames", type=int, default=101)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    base = AirfoilConfig(nx=a.nx, ny=a.nx, n_frames=a.frames)
    generate_dataset(a.out, list(range(a.seed_start, a.seed_start + a.nsample)), base,
                     device=a.device)


if __name__ == "__main__":
    main()
