"""Spectral vorticity: omega = curl(v) via FFT spectral derivatives (port of
``sciml_pde_tpu/sim/vorticity.py``; reference
``pdebench/data_gen/src/vorticity.py:26-150``).  Velocity fields on a
(n, sx, sy, sz, 3) grid give the three vorticity components by spectral
differentiation; ``sim/velocity2vorticity.py`` converts PDEBench 3D CFD
files with it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _spectral_grad(f: torch.Tensor, axis: int, length: float) -> torch.Tensor:
    n = f.shape[axis]
    k = torch.fft.fftfreq(n, d=length / n, device=f.device) * 2 * math.pi
    shape = [1] * f.ndim
    shape[axis] = n
    fk = torch.fft.fft(f, dim=axis)
    return torch.real(torch.fft.ifft(1j * k.reshape(shape) * fk, dim=axis))


def compute_spectral_vorticity_jnp(
    vel: torch.Tensor, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> torch.Tensor:
    """vel: (n, sx, sy, sz, 3) -> vorticity (n, sx, sy, sz, 3), on vel's
    device (the name is the JAX package's, for the tensor version)."""
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    wx = _spectral_grad(vz, 2, ly) - _spectral_grad(vy, 3, lz)
    wy = _spectral_grad(vx, 3, lz) - _spectral_grad(vz, 1, lx)
    wz = _spectral_grad(vy, 1, lx) - _spectral_grad(vx, 2, ly)
    return torch.stack([wx, wy, wz], dim=-1)


def compute_spectral_vorticity_np(vel: np.ndarray, lx=1.0, ly=1.0, lz=1.0) -> np.ndarray:
    """Numpy in and out (computed on the CPU)."""
    return compute_spectral_vorticity_jnp(torch.as_tensor(np.asarray(vel, np.float32)),
                                          lx, ly, lz).numpy()
