"""Gaussian-random-field / spectral noise initial conditions (port of
``sciml_pde_tpu/sim/grf.py``).

Two flavours:
  - ``grf_rbf``: isotropic RBF-covariance GRF via spectral sampling
    (reference ``pdebench/data_gen/src/_attic/grf.py:7-47``);
  - ``spectral_noise``: power-law smooth noise with the behaviour of
    phiflow's ``Noise(scale=..., smoothness=...)`` that initialises NS
    velocity, particles and force (reference sim_ns_incomp_2d.py:244-278):
    white noise shaped by |k|^-smoothness, band-limited, normalised to the
    std ``scale``.

Each is a draw of complex white noise from an explicit ``torch.Generator``
followed by a deterministic filter (``spectral_filter``, ``rbf_filter``)
that takes the noise's real and imaginary parts as tensors.  The port
cannot reproduce JAX's PRNG bits, so its fields are fresh draws; parity
with JAX is held for the same draws, by feeding JAX's normals to the
filters.
"""

from __future__ import annotations

import math

import torch

from sciml_pde_torch._device import resolve_device


def _white(generator: torch.Generator, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts, standard normal, drawn in that order on the
    generator's device and moved to ``device``."""
    wr = torch.randn(shape, generator=generator, device=generator.device)
    wi = torch.randn(shape, generator=generator, device=generator.device)
    return wr.to(device), wi.to(device)


def rbf_filter(wr: torch.Tensor, wi: torch.Tensor, length_scale: float = 0.1) -> torch.Tensor:
    """RBF-covariance GRF on the unit square from white noise ``wr + i wi``
    (nx, ny) by circulant embedding, normalised to unit std."""
    nx, ny = wr.shape[-2], wr.shape[-1]
    kx = torch.fft.fftfreq(nx, device=wr.device)[:, None] * nx
    ky = torch.fft.fftfreq(ny, device=wr.device)[None, :] * ny
    # spectral density of the RBF kernel (Gaussian in k)
    s = torch.exp(-2.0 * (math.pi * length_scale) ** 2
                  * ((kx / nx) ** 2 + (ky / ny) ** 2) * (nx * ny))
    f = torch.fft.ifft2(torch.sqrt(s) * torch.complex(wr, wi)).real
    return f / (torch.std(f, correction=0) + 1e-12)


def grf_rbf(generator: torch.Generator, shape: tuple[int, int], length_scale: float = 0.1,
            device=None) -> torch.Tensor:
    """RBF-covariance GRF of ``shape`` (nx, ny), a fresh draw from
    ``generator``, on ``device``."""
    wr, wi = _white(generator, tuple(shape), resolve_device(device))
    return rbf_filter(wr, wi, length_scale)


def spectral_filter(wr: torch.Tensor, wi: torch.Tensor, scale: float = 0.15,
                    smoothness: float = 3.0) -> torch.Tensor:
    """|k|^-smoothness shaped white noise ``wr + i wi`` (..., nx, ny),
    band-limited at |k| 0.45, zero mean, each trailing 2D field scaled to
    std ``scale``."""
    nx, ny = wr.shape[-2], wr.shape[-1]
    kx = torch.fft.fftfreq(nx, device=wr.device)[:, None]
    ky = torch.fft.fftfreq(ny, device=wr.device)[None, :]
    k = torch.sqrt(kx**2 + ky**2)
    k[0, 0] = 1.0
    amp = k ** (-float(smoothness))
    amp[0, 0] = 0.0  # zero mean
    # band-limit the highest frequencies a little for smoothness parity
    amp = torch.where(k > 0.45, 0.0, amp)
    f = torch.fft.ifft2(torch.complex(wr, wi) * amp, dim=(-2, -1)).real
    std = torch.std(f, dim=(-2, -1), keepdim=True, correction=0) + 1e-12
    return f / std * scale


def spectral_noise(
    generator: torch.Generator,
    shape: tuple[int, ...],
    scale: float = 0.15,
    smoothness: float = 3.0,
    device=None,
) -> torch.Tensor:
    """Smooth random field of ``shape`` (..., nx, ny), every leading index
    drawn iid from ``generator``; std ``scale``; on ``device``."""
    wr, wi = _white(generator, tuple(shape), resolve_device(device))
    return spectral_filter(wr, wi, scale, smoothness)
