"""Audit: does the DR inhibitor channel die at frame 10 in reference-style
data?  (Port of the JAX package's ``experiments/dr_data_audit.py``.)

Integrates the same FVM FitzHugh-Nagumo system three ways for a held-out
test seed (the reference's test split = the last 10% of keys, i.e. seeds
90+ of a 100-sample file):

  1. scipy solve_ivp RK45 at the reference's tolerances (solve_ivp defaults
     rtol 1e-3 / atol 1e-6: ``pdebench/data_gen/src/sim_diff_react.py:127``
     passes none), on the host;
  2. scipy solve_ivp RK45 tight (rtol 1e-6 / atol 1e-9), the ground truth;
  3. the port's fixed-step RK4 generator (``sim/diff_react.py``), on the
     device.

Reports the per-frame channel RMS around the eval window (frames 0..30),
which settles the "v target RMS at frame 10" question at data level.
Runs on the card; ``--device cpu`` runs the generator on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy.integrate import solve_ivp

from sciml_pde_torch.sim.diff_react import (DiffReactConfig, generate_trajectories,
                                            initial_condition)


def scipy_traj(seed: int, cfg: DiffReactConfig, rtol: float, atol: float) -> np.ndarray:
    """The seed's trajectory from scipy's RK45 in f64, (T, H, W, 2)."""
    ic = initial_condition(seed, cfg)  # (H, W, 2)
    u0 = np.concatenate([ic[..., 0].ravel(), ic[..., 1].ravel()])
    inv_dx2, inv_dy2 = 1.0 / cfg.dx**2, 1.0 / cfg.dy**2
    n = cfg.xdim * cfg.ydim

    def lap(f):
        f = f.reshape(cfg.ydim, cfg.xdim)
        fp = np.pad(f, 1, mode="edge")
        out = (fp[1:-1, :-2] - 2 * f + fp[1:-1, 2:]) * inv_dx2 + (
            fp[:-2, 1:-1] - 2 * f + fp[2:, 1:-1]
        ) * inv_dy2
        return out.ravel()

    def rhs(t, y):
        u, v = y[:n], y[n:]
        u_t = u - u**3 - cfg.k - v + cfg.Du * lap(u)
        v_t = u - v + cfg.Dv * lap(v)
        return np.concatenate([u_t, v_t])

    sol = solve_ivp(rhs, (0, cfg.t), u0, t_eval=cfg.tgrid, rtol=rtol, atol=atol)
    traj = sol.y.T.reshape(cfg.tdim, 2, cfg.ydim, cfg.xdim)
    return np.moveaxis(traj, 1, -1)  # (T, H, W, 2)


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))


def channel_rms(traj: np.ndarray, frames) -> dict[str, list[float]]:
    return {"u_rms": [rms(traj[f, ..., 0]) for f in frames],
            "v_rms": [rms(traj[f, ..., 1]) for f in frames]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=90)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--frames", type=int, nargs="+", default=[0, 5, 10, 15, 20, 30])
    p.add_argument("--skip-tight", action="store_true")
    p.add_argument("--out", default="runs/dr_data_audit.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device

    dev = resolve_device(a.device)
    cfg = DiffReactConfig(xdim=a.grid, ydim=a.grid)
    report = {"seed": a.seed, "grid": a.grid, "frames": a.frames}

    ours = generate_trajectories([a.seed], cfg, device=dev)[0]
    report["rk4_ours"] = channel_rms(ours, a.frames)
    print("rk4_ours   ", json.dumps(report["rk4_ours"]), flush=True)

    ref = scipy_traj(a.seed, cfg, rtol=1e-3, atol=1e-6)
    report["rk45_ref_tol"] = channel_rms(ref, a.frames)
    report["frame10_rel_l2_ours_vs_reftol"] = rms(ref[10] - ours[10]) / rms(ref[10])
    print("rk45_ref   ", json.dumps(report["rk45_ref_tol"]), flush=True)

    if not a.skip_tight:
        tight = scipy_traj(a.seed, cfg, rtol=1e-6, atol=1e-9)
        report["rk45_tight"] = channel_rms(tight, a.frames)
        report["frame10_rel_l2_reftol_vs_tight"] = rms(ref[10] - tight[10]) / rms(tight[10])
        report["frame10_rel_l2_ours_vs_tight"] = rms(ours[10] - tight[10]) / rms(tight[10])
        print("rk45_tight ", json.dumps(report["rk45_tight"]), flush=True)

    with open(a.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if "rel_l2" in k}, indent=1))
    return report


if __name__ == "__main__":
    main()
