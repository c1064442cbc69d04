"""2D FitzHugh-Nagumo diffusion-reaction simulator (port of
``sciml_pde_tpu/sim/diff_react.py``).

Finite-volume grid with no-flux Neumann BCs, activator/inhibitor reaction
terms, and the ``sim_type in {all, react, diff}`` decomposition that makes
the paper's "basic physics forms" aux datasets.  The Laplacian is the
5-point stencil with edge padding; time integration is fixed-step RK4 with
a stability-bounded substep count.  Where JAX scans, the port loops over
the substeps on the device, batched over seeds, with no host sync until
the trajectories are fetched.  The RK4 update keeps JAX's order of
operations, ``s + (dt/6)(k1 + 2k2 + 2k3 + k4)``.

Initial conditions come from ``np.random.default_rng(seed)`` on the host,
so the port's ICs are byte-identical to the JAX package's and the
reference's (same seed, same IC).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiffReactConfig:
    """Defaults mirror the generation config the datasets were built with
    (reference ``data_gen/configs/diff-react.yaml:24-38``)."""

    Du: float = 1e-3
    Dv: float = 1e-1
    k: float = 5e-3
    t: float = 5.0
    tdim: int = 101
    x_left: float = -1.0
    x_right: float = 1.0
    xdim: int = 128
    y_bottom: float = -1.0
    y_top: float = 1.0
    ydim: int = 128
    sim_type: str = "all"  # all | react | diff

    @property
    def dx(self) -> float:
        return (self.x_right - self.x_left) / self.xdim

    @property
    def dy(self) -> float:
        return (self.y_top - self.y_bottom) / self.ydim

    @property
    def x(self) -> np.ndarray:
        return np.linspace(
            self.x_left + self.dx / 2, self.x_right - self.dx / 2, self.xdim
        ).astype(np.float32)

    @property
    def y(self) -> np.ndarray:
        return np.linspace(
            self.y_bottom + self.dy / 2, self.y_top - self.dy / 2, self.ydim
        ).astype(np.float32)

    @property
    def tgrid(self) -> np.ndarray:
        return np.linspace(0, self.t, self.tdim).astype(np.float32)


def initial_condition(seed: int, cfg: DiffReactConfig) -> np.ndarray:
    """Standard-normal IC, the reference's sample stream: u then v from
    ``default_rng(seed)``; (Ny, Nx, 2) float32."""
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal(cfg.xdim * cfg.ydim).reshape(cfg.ydim, cfg.xdim)
    v0 = rng.standard_normal(cfg.xdim * cfg.ydim).reshape(cfg.ydim, cfg.xdim)
    return np.stack([u0, v0], axis=-1).astype(np.float32)


def laplacian_neumann(u: torch.Tensor, inv_dx2: float, inv_dy2: float) -> torch.Tensor:
    """5-point Laplacian with no-flux (zero-gradient) BCs on (..., Ny, Nx):
    at a wall the missing neighbour equals the cell itself."""
    px = torch.cat([u[..., :, :1], u, u[..., :, -1:]], dim=-1)
    lx = (px[..., :, 2:] - 2.0 * u + px[..., :, :-2]) * inv_dx2
    py = torch.cat([u[..., :1, :], u, u[..., -1:, :]], dim=-2)
    ly = (py[..., 2:, :] - 2.0 * u + py[..., :-2, :]) * inv_dy2
    return lx + ly


def _rhs_cf(s: torch.Tensor, cfg: DiffReactConfig, diff_coef: torch.Tensor) -> torch.Tensor:
    """The RHS on a channels-first state (..., 2, Ny, Nx): u and v are
    slices, and one Laplacian call takes both, times ``diff_coef`` =
    (Du, Dv) broadcast per channel.  Elementwise the same operations as
    ``_rhs``."""
    u, v = s[..., 0, :, :], s[..., 1, :, :]
    if cfg.sim_type in ("all", "react"):
        react = torch.stack([u - u**3 - cfg.k - v, u - v], dim=-3)
        if cfg.sim_type == "react":
            return react
    elif cfg.sim_type != "diff":
        raise ValueError(f"unknown sim_type {cfg.sim_type!r}")
    diff = diff_coef * laplacian_neumann(s, 1.0 / cfg.dx**2, 1.0 / cfg.dy**2)
    return diff if cfg.sim_type == "diff" else react + diff


def _rhs(state: torch.Tensor, cfg: DiffReactConfig) -> torch.Tensor:
    """FitzHugh-Nagumo RHS on (..., Ny, Nx, 2); ``sim_type`` selects the
    full equation or a decomposed basic form."""
    coef = torch.tensor([cfg.Du, cfg.Dv], dtype=state.dtype, device=state.device)
    out = _rhs_cf(torch.movedim(state, -1, -3), cfg, coef[:, None, None])
    return torch.movedim(out, -3, -1)


def stability_substeps(cfg: DiffReactConfig, safety: float = 0.5) -> int:
    """Substeps per output frame keeping RK4 inside its stability region:
    explicit diffusion eigenvalue bound 4 D (1/dx^2 + 1/dy^2), the reaction
    Jacobian bound 40, RK4's real-axis limit ~2.785."""
    lam_react = 40.0
    if cfg.sim_type == "react":
        lam = lam_react
    elif cfg.sim_type == "diff":
        lam = 4.0 * max(cfg.Du, cfg.Dv) * (1.0 / cfg.dx**2 + 1.0 / cfg.dy**2)
    else:
        lam = 4.0 * max(cfg.Du, cfg.Dv) * (1.0 / cfg.dx**2 + 1.0 / cfg.dy**2) + lam_react
    dt_frame = cfg.t / (cfg.tdim - 1)
    dt_max = safety * 2.785 / lam
    return max(1, math.ceil(dt_frame / dt_max))


@torch.no_grad()
def simulate_diff_react(ic, cfg: DiffReactConfig, substeps: int | None = None,
                        device=None) -> torch.Tensor:
    """Integrate one (or a batch of) trajectories from ``ic`` (..., Ny, Nx,
    2).  Returns (tdim, ..., Ny, Nx, 2) including the initial frame, on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if substeps is None:
        substeps = stability_substeps(cfg)
    dt = cfg.t / (cfg.tdim - 1) / substeps
    s = torch.movedim(torch.as_tensor(ic, dtype=torch.float32, device=dev), -1, -3)
    coef = torch.tensor([cfg.Du, cfg.Dv], dtype=torch.float32, device=dev)[:, None, None]
    frames = torch.empty((cfg.tdim, *s.shape), dtype=torch.float32, device=dev)
    frames[0] = s
    for i in range(1, cfg.tdim):
        for _ in range(substeps):
            k1 = _rhs_cf(s, cfg, coef)
            k2 = _rhs_cf(s + 0.5 * dt * k1, cfg, coef)
            k3 = _rhs_cf(s + 0.5 * dt * k2, cfg, coef)
            k4 = _rhs_cf(s + dt * k3, cfg, coef)
            s = s + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        frames[i] = s
    return torch.movedim(frames, -3, -1)


def generate_trajectories(seeds: list[int], cfg: DiffReactConfig, substeps: int | None = None,
                          device=None) -> np.ndarray:
    """Batched generation: (len(seeds), tdim, Ny, Nx, 2), the seeds
    integrated together on ``device``."""
    ics = np.stack([initial_condition(s, cfg) for s in seeds])
    traj = simulate_diff_react(ics, cfg, substeps, device=device)
    return torch.movedim(traj, 0, 1).cpu().numpy()
