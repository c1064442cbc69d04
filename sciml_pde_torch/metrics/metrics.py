"""Training loss and evaluation metrics (port of
``sciml_pde_tpu/metrics/metrics.py``).

The six PDEBench metrics (``metric_func``): RMSE, normalized RMSE, conserved
variable RMSE, max error, boundary RMSE and the radially binned Fourier-space
RMSE in low / mid / high bands; the loss library (``lp_loss``,
``fft_lp_loss``, ``fft_mse_loss``) and the inverse-problem metric dict
(``inverse_metrics``).  Arrays are channels-last ``(B, x1, ..., xd, T, C)``
for d in {1, 2, 3}, as in the JAX package.

The Fourier RMSE bins the squared spectral error by radius with a one-hot
``(K, nbins + 1)`` product in f64 over a static bin map, where JAX takes a
``segment_sum``: the same bits on every run (no atomics), and no TF32
whatever the matmul flags say.  A band with no bins (``iHigh`` at or above
``min(spatial) // 2``) is the mean of nothing, NaN, as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def nrmse_loss(output: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Per-sample nRMSE^2 averaged over the batch: the mean squared residual
    over dims (1, 2, 3), normalised by the target power over the same dims
    plus 1e-7.  Works for (B, X, Y, T, C)."""
    dims = (1, 2, 3)
    residuals = output - tar
    tar_norm = 1e-7 + (tar * tar).mean(dim=dims, keepdim=True)
    raw = (residuals * residuals).mean(dim=dims, keepdim=True) / tar_norm
    return raw.mean()


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, T, C) -> (B, C, *spatial, T)."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


@functools.lru_cache(maxsize=64)
def _radial_bins(spatial: tuple[int, ...]) -> tuple[np.ndarray, int]:
    """Radial bin of each retained wavenumber tuple (indices below n // 2 on
    every axis): floor(sqrt(sum i^2)), with bins past min(n // 2) - 1 in an
    overflow bin ``nbins`` that is dropped."""
    half = [n // 2 for n in spatial]
    nbins = min(half)
    grids = np.meshgrid(*[np.arange(h) for h in half], indexing="ij")
    r = np.floor(np.sqrt(sum(g.astype(np.float64) ** 2 for g in grids))).astype(np.int64)
    return np.where(r > nbins - 1, nbins, r), nbins


def _fourier_rmse(pred_cf: torch.Tensor, target_cf: torch.Tensor, scale: float) -> torch.Tensor:
    """Radially binned Fourier RMSE of (B, C, *spatial, T) fields ->
    (C, nbins, T); in 1D the rfft modes, unbinned."""
    ndim_sp = pred_cf.ndim - 3
    spatial = tuple(pred_cf.shape[2:2 + ndim_sp])
    if ndim_sp == 1:
        pf = torch.fft.rfft(pred_cf, dim=2)
        tf = torch.fft.rfft(target_cf, dim=2)
        return torch.sqrt((pf - tf).abs().square().mean(dim=0)) / spatial[0] * scale

    axes = tuple(range(2, 2 + ndim_sp))
    err2 = (torch.fft.fftn(pred_cf, dim=axes) - torch.fft.fftn(target_cf, dim=axes)).abs()
    err2 = err2.square()[(slice(None), slice(None)) + tuple(slice(0, n // 2) for n in spatial)]
    bin_id, nbins = _radial_bins(spatial)
    b, c, t = err2.shape[0], err2.shape[1], err2.shape[-1]
    onehot = torch.zeros(bin_id.size, nbins + 1, dtype=torch.float64, device=err2.device)
    onehot[torch.arange(bin_id.size), torch.from_numpy(bin_id.ravel())] = 1.0
    flat = err2.reshape(b, c, -1, t).transpose(2, 3).double()  # (B, C, T, K)
    binned = (flat @ onehot)[..., :nbins].float().transpose(2, 3)  # (B, C, nbins, T)
    return torch.sqrt(binned.mean(dim=0)) / float(np.prod(spatial)) * scale


def metric_func(pred: torch.Tensor, target: torch.Tensor, if_mean: bool = True,
                Lx: float = 1.0, Ly: float = 1.0, Lz: float = 1.0, iLow: int = 4,
                iHigh: int = 12):
    """The six PDEBench metrics of ``(B, *spatial, T, C)`` fields with 1-3
    spatial dims: (err_RMSE, err_nRMSE, err_CSV, err_Max, err_BD, err_F),
    0-dim tensors if ``if_mean``, else per-(C, T) tensors (err_F (C, 3, T);
    err_BD (T,) in 3D)."""
    pred = _channels_first(pred.float())
    target = _channels_first(target.float())
    nb, nc, nt = pred.shape[0], pred.shape[1], pred.shape[-1]
    ndim_sp = pred.ndim - 3
    spatial = tuple(pred.shape[2:2 + ndim_sp])
    nxyz = int(np.prod(spatial))

    pflat = pred.reshape(nb, nc, -1, nt)
    tflat = target.reshape(nb, nc, -1, nt)
    err_mean = torch.sqrt((pflat - tflat).square().mean(dim=2))  # (B, C, T)
    err_RMSE = err_mean.mean(dim=0)
    nrm = torch.sqrt(tflat.square().mean(dim=2))
    err_nRMSE = (err_mean / nrm).mean(dim=0)
    err_CSV = torch.sqrt((pflat.sum(dim=2) - tflat.sum(dim=2)).square().mean(dim=0)) / nxyz
    err_Max = (pflat - tflat).abs().amax(dim=2).amax(dim=0)

    # boundary RMSE: squared error summed over every face of the domain
    # (a corner cell counts once per face it lies on)
    def faces(axis):
        lo = pred.select(axis, 0) - target.select(axis, 0)
        hi = pred.select(axis, -1) - target.select(axis, -1)
        return lo.square() + hi.square()

    if ndim_sp == 1:
        err_BD = torch.sqrt(faces(2) / 2.0).mean(dim=0)
    elif ndim_sp == 2:
        nx, ny = spatial
        bd = (faces(2).sum(dim=-2) + faces(3).sum(dim=-2)) / (2 * nx + 2 * ny)
        err_BD = torch.sqrt(bd).mean(dim=0)
    else:
        nx, ny, nz = spatial
        bd = sum(faces(a).reshape(nb, -1, nt).sum(dim=-2) for a in (2, 3, 4))
        bd = bd / (2 * nx * ny + 2 * ny * nz + 2 * nz * nx)
        err_BD = torch.sqrt(bd).mean(dim=0)  # (T,): summed over channels

    scale = {1: Lx, 2: Lx * Ly, 3: Lx * Ly * Lz}[ndim_sp]
    f = _fourier_rmse(pred, target, scale)  # (C, nbins, T)
    err_F = torch.stack([f[:, :iLow].mean(dim=1), f[:, iLow:iHigh].mean(dim=1),
                         f[:, iHigh:].mean(dim=1)], dim=1)  # (C, 3, T)
    out = (err_RMSE, err_nRMSE, err_CSV, err_Max, err_BD, err_F)
    return tuple(e.mean() for e in out) if if_mean else out


def _reduce(r: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return r.mean()
    if reduction == "sum":
        return r.sum()
    return r


def lp_loss(x: torch.Tensor, y: torch.Tensor, p: int = 2, reduction: str = "mean",
            eps: float = 1e-20) -> torch.Tensor:
    """Relative Lp loss per sample: ||x - y||_p / (eps + ||y||_p)."""
    n = x.shape[0]
    diff = torch.linalg.vector_norm(x.reshape(n, -1) - y.reshape(n, -1), ord=p, dim=1)
    norm = eps + torch.linalg.vector_norm(y.reshape(n, -1), ord=p, dim=1)
    return _reduce(diff / norm, reduction)


def _band_slice(xf: torch.Tensor, flow: int | None, fhigh: int | None, ndims: int):
    flow = 0 if flow is None else flow
    fhigh = max(xf.shape[1:]) if fhigh is None else fhigh
    return xf[(slice(None),) + (slice(flow, fhigh),) * ndims]


def fft_lp_loss(x: torch.Tensor, y: torch.Tensor, flow: int | None = None,
                fhigh: int | None = None, p: int = 2, reduction: str = "mean",
                eps: float = 1e-20) -> torch.Tensor:
    """Relative Lp loss of the band [flow, fhigh) of the FFT over every axis
    but the first."""
    n = x.shape[0]
    dims = tuple(range(1, x.ndim))
    xf = _band_slice(torch.fft.fftn(x, dim=dims), flow, fhigh, x.ndim - 1)
    yf = _band_slice(torch.fft.fftn(y, dim=dims), flow, fhigh, x.ndim - 1)
    diff = torch.linalg.vector_norm((xf - yf).reshape(n, -1), ord=p, dim=1)
    norm = eps + torch.linalg.vector_norm(yf.reshape(n, -1), ord=p, dim=1)
    return _reduce(diff / norm, reduction)


def fft_mse_loss(x: torch.Tensor, y: torch.Tensor, flow: int | None = None,
                 fhigh: int | None = None, reduction: str = "mean") -> torch.Tensor:
    """MSE of the band [flow, fhigh) of the FFT over axes 1 .. ndim - 2 (the
    last axis is not transformed)."""
    n = x.shape[0]
    dims = tuple(range(1, x.ndim - 1))
    xf = _band_slice(torch.fft.fftn(x, dim=dims), flow, fhigh, x.ndim - 2)
    yf = _band_slice(torch.fft.fftn(y, dim=dims), flow, fhigh, x.ndim - 2)
    return _reduce((xf - yf).reshape(n, -1).abs().square(), reduction)


def inverse_metrics(u0, x, pred_u0, y) -> dict[str, float]:
    """The inverse-problem metric dict: MSE, L2 and L3 of the recovered
    initial condition and of its forward prediction, and the FFT losses over
    the whole spectrum and its low, mid and high bands."""
    def flat(a):
        return a.reshape(1, -1)

    out = {}
    out["mseloss_u0"] = float((flat(u0) - flat(x)).square().mean())
    out["l2loss_u0"] = float(lp_loss(flat(u0), flat(x), p=2))
    out["l3loss_u0"] = float(lp_loss(flat(u0), flat(x), p=3))

    def bands(n):
        fmid = n // 4
        return {"": (None, None), "_low": (0, fmid), "_mid": (fmid, 2 * fmid),
                "_hi": (2 * fmid, None)}

    for suf, (lo, hi) in bands(u0.shape[1]).items():
        out[f"fftmseloss{suf}_u0"] = float(fft_mse_loss(u0, x, lo, hi))
        out[f"fftl2loss{suf}_u0"] = float(fft_lp_loss(u0, x, lo, hi, p=2))
        out[f"fftl3loss{suf}_u0"] = float(fft_lp_loss(u0, x, lo, hi, p=3))

    out["mseloss_pred_u0"] = float((flat(pred_u0) - flat(y)).square().mean())
    out["l2loss_pred_u0"] = float(lp_loss(flat(pred_u0), flat(y), p=2))
    out["l3loss_pred_u0"] = float(lp_loss(flat(pred_u0), flat(y), p=3))

    fb = bands(pred_u0.shape[1])
    pred_u0, y = pred_u0.squeeze(-1), y.squeeze(-1)
    for suf, (lo, hi) in fb.items():
        out[f"fftmseloss{suf}_pred_u0"] = float(fft_mse_loss(pred_u0, y, lo, hi))
        out[f"fftl2loss{suf}_pred_u0"] = float(fft_lp_loss(pred_u0, y, lo, hi, p=2))
        out[f"fftl3loss{suf}_pred_u0"] = float(fft_lp_loss(pred_u0, y, lo, hi, p=3))
    return out
