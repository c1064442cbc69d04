"""1D viscous Burgers data generator, PDEBench file format (port of
``sciml_pde_tpu/sim/burgers_1d.py``).

The reference's OFormer/Hyena comparison suites train on PDEBench 1D
Burgers datasets ("OFormer Model Comparison/nn_module/train_burgers.py",
``dataset.py``) but the fork ships no generator for them.

Physics: u_t + u u_x = nu u_xx on the periodic unit interval.
Scheme: pseudo-spectral with 2/3 dealiasing; stiff diffusion handled
exactly by an integrating factor exp(-nu k^2 dt); Heun (RK2) on the
advection term, in complex64 FFTs as JAX's.  The trajectory's substeps run
on the device with no host sync (on the card, replayed as a CUDA graph a
frame).

Initial condition: random superposition of sinusoids with wavenumbers
<= ``max_k``, normalised to max|u| = 1 (the PDEBench Burgers IC family),
drawn from an explicit ``torch.Generator``.  The port cannot reproduce
JAX's PRNG bits, so parity with JAX is held on JAX's draws
(``sine_ic``).  Because Burgers obeys a maximum principle, |u| <= 1 for
all time, so a static CFL timestep is sound.

On-disk format (PDEBench 1D convention, e.g. 1D_Burgers_Sols_Nu0.01.hdf5),
written through ``io/h5.py::h5py_module`` a batch at a time:
  /tensor        (N, T, X) float32
  /x-coordinate  (X,)
  /t-coordinate  (T,)
  attrs: nu

  python -m sciml_pde_torch.sim.burgers_1d --out data/1D_Burgers_Sols_Nu0.01.h5

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.io import h5 as h5io


def sine_ic(amp: torch.Tensor, keep_u: torch.Tensor, phase_u: torch.Tensor,
            nx: int) -> torch.Tensor:
    """(N, X) superposed sinusoids, max|u| = 1, from the draws: ``amp``
    standard normal, ``keep_u`` and ``phase_u`` uniform on [0, 1), each
    (N, max_k).  A mode takes part where its ``keep_u`` < 0.6."""
    max_k = amp.shape[1]
    ks = torch.arange(1, max_k + 1, dtype=torch.float32, device=amp.device)
    amp = amp * (keep_u < 0.6)
    phase = phase_u * (2.0 * math.pi)
    x = torch.arange(nx, dtype=torch.float32, device=amp.device) / nx
    u0 = torch.sum(
        amp[:, :, None] * torch.sin(2.0 * math.pi * ks[None, :, None] * x[None, None, :]
                                    + phase[:, :, None]),
        dim=1,
    )
    peak = torch.amax(torch.abs(u0), dim=1, keepdim=True) + 1e-12
    return u0 / peak


def random_sine_ic(generator: torch.Generator, n: int, nx: int, max_k: int = 8,
                   device=None) -> torch.Tensor:
    """(N, X) superposed sinusoids, max|u| = 1: amplitudes, participations
    and phases drawn from ``generator`` in that order, on ``device``."""
    dev = resolve_device(device)
    draw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    amp = torch.randn((n, max_k), **draw)
    keep_u = torch.rand((n, max_k), **draw)
    phase_u = torch.rand((n, max_k), **draw)
    return sine_ic(amp.to(dev), keep_u.to(dev), phase_u.to(dev), nx)


@torch.no_grad()
def simulate_burgers(u0: torch.Tensor, nu: float, t_final: float, nx: int, n_frames: int,
                     substeps_per_frame: int) -> torch.Tensor:
    """(B, n_frames, X) trajectory of ``u0`` (B, X), |u| <= 1, including the
    initial frame, on ``u0``'s device.  On the card a frame's substeps are
    captured once as a CUDA graph and replayed (``utils/cuda_graph.py``)."""
    dev = u0.device
    k = 2.0 * math.pi * torch.fft.fftfreq(nx, device=dev) * nx  # wavenumbers on [0,1)
    ik = torch.complex(torch.zeros_like(k), k)
    dealias = (torch.abs(k) <= (2.0 / 3.0) * math.pi * nx).to(torch.complex64)
    dt = t_final / ((n_frames - 1) * substeps_per_frame)
    ef = torch.exp(-nu * k**2 * dt).to(torch.complex64)

    def nonlin(u_hat):
        u = torch.fft.ifft(u_hat, dim=-1).real
        ux = torch.fft.ifft(ik * u_hat, dim=-1).real
        return torch.fft.fft(-u * ux, dim=-1) * dealias

    def frame(u_hat):
        for _ in range(substeps_per_frame):
            n0 = nonlin(u_hat)
            u1 = ef * (u_hat + dt * n0)
            n1 = nonlin(u1)
            u_hat = ef * u_hat + 0.5 * dt * (ef * n0 + n1)
        return u_hat, torch.fft.ifft(u_hat, dim=-1).real

    u_hat = torch.fft.fft(u0.to(torch.complex64), dim=-1)
    if dev.type == "cuda" and n_frames > 2:
        from sciml_pde_torch.utils.cuda_graph import graphed

        frame = graphed(frame, u_hat)
    frames = [u0.to(torch.float32)]
    for _ in range(n_frames - 1):
        u_hat, u = frame(u_hat)
        frames.append(u.clone())
    return torch.stack(frames, dim=1).to(torch.float32)


def burgers_substeps(nx: int, n_frames: int, t_final: float, cfl: float = 0.4) -> int:
    """Substeps a frame: |u| <= 1 (maximum principle) bounds the advective
    dt by cfl * dx; the integrating factor removes the diffusive limit."""
    dt_frame = t_final / (n_frames - 1)
    return max(int(np.ceil(dt_frame / (cfl * (1.0 / nx)))), 1)


def generate_burgers_file(
    out: str | Path,
    n_samples: int = 32,
    nx: int = 1024,
    n_frames: int = 201,
    t_final: float = 2.0,
    nu: float = 0.01,
    max_k: int = 8,
    seed: int = 0,
    batch: int = 32,
    cfl: float = 0.4,
    device=None,
) -> Path:
    """Write ``n_samples`` trajectories, ``batch`` at a time, each batch's
    initial conditions drawn in turn from ``torch.Generator().manual_seed(
    seed)``."""
    dev = resolve_device(device)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    substeps = burgers_substeps(nx, n_frames, t_final, cfl)
    gen = torch.Generator().manual_seed(int(seed))
    with h5io.h5py_module().File(out, "w") as f:
        dset = f.create_dataset(
            "tensor", (n_samples, n_frames, nx), dtype="float32",
            chunks=(1, n_frames, nx), compression="lzf",
        )
        f.create_dataset("x-coordinate",
                         data=np.linspace(0, 1, nx, endpoint=False, dtype=np.float32))
        f.create_dataset("t-coordinate",
                         data=np.linspace(0, t_final, n_frames, dtype=np.float32))
        f.attrs["nu"] = nu
        for b0 in range(0, n_samples, batch):
            nb = min(batch, n_samples - b0)
            u0 = random_sine_ic(gen, nb, nx, max_k=max_k, device=dev)
            traj = simulate_burgers(u0, nu, t_final, nx, n_frames, substeps)
            dset[b0 : b0 + nb] = traj.cpu().numpy()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="data/1D_Burgers_Sols_Nu0.01.h5")
    p.add_argument("--nsample", type=int, default=32)
    p.add_argument("--xdim", type=int, default=1024)
    p.add_argument("--tdim", type=int, default=201)
    p.add_argument("--t", type=float, default=2.0)
    p.add_argument("--nu", type=float, default=0.01)
    p.add_argument("--max-k", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    path = generate_burgers_file(
        a.out, n_samples=a.nsample, nx=a.xdim, n_frames=a.tdim, t_final=a.t,
        nu=a.nu, max_k=a.max_k, seed=a.seed, batch=a.batch, device=a.device,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
