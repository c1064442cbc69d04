"""Port metrics/metrics.py vs the JAX package's: the six PDEBench metrics in
1, 2 and 3 spatial dims (if_mean both ways, an empty Fourier band), the
four losses and inverse_metrics, on the same numpy-seeded fields.

Tolerances: 1e-5 relative in f32; 1e-4 where a sum over the grid or an FFT
sets the error (CSV, F, the Fourier losses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.metrics import metrics as jm
from sciml_pde_torch.metrics import metrics as tm

NAMES = ("RMSE", "nRMSE", "CSV", "Max", "BD", "F")
RTOL = {"RMSE": 1e-5, "nRMSE": 1e-5, "CSV": 1e-4, "Max": 1e-5, "BD": 1e-5, "F": 1e-4}


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    tgt = rng.normal(size=shape).astype(np.float32) + 0.5
    pred = (tgt + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return pred, tgt


def _both(fn_j, fn_t, *arrays, **kw):
    return fn_j(*map(jnp.asarray, arrays), **kw), fn_t(*map(torch.from_numpy, arrays), **kw)


def _close(got, want, rtol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN places")
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max() if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=rtol * scale, err_msg=what)


# (B, *spatial, T, C), iLow, iHigh: 1D, 2D with all three bands, 2D at 16^2
# whose high band (iHigh 12 >= 16 // 2) is empty, 3D, and 2D non-square
CASES = {
    "1d": ((3, 32, 4, 2), 4, 12),
    "2d": ((2, 32, 32, 3, 2), 4, 12),
    "2d_empty_high": ((2, 16, 16, 3, 2), 4, 12),
    "3d": ((2, 12, 10, 8, 2, 3), 2, 4),
    "2d_rect": ((2, 24, 20, 2, 1), 3, 6),
}


@pytest.mark.parametrize("if_mean", [True, False], ids=["mean", "per_ct"])
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_metric_func_matches_jax(case, if_mean):
    shape, lo, hi = case
    pred, tgt = _fields(shape, seed=len(shape) + shape[1])
    want, got = _both(jm.metric_func, tm.metric_func, pred, tgt, if_mean=if_mean, iLow=lo,
                      iHigh=hi)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, RTOL[name], f"{name} {shape} if_mean={if_mean}")
    if case is CASES["2d_empty_high"]:  # NaN exactly in the high band
        err_f = got[5] if if_mean else got[5][:, 2]
        assert bool(torch.isnan(err_f).all())
        assert if_mean or not bool(torch.isnan(got[5][:, :2]).any())


def test_metric_func_scales_the_fourier_rmse_by_the_domain():
    pred, tgt = _fields((2, 32, 32, 2, 2), seed=5)
    want, got = _both(jm.metric_func, tm.metric_func, pred, tgt, Lx=2.0, Ly=3.0)
    _close(got[5], want[5], 1e-4, "F with Lx=2, Ly=3")


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("p", [2, 3])
def test_lp_loss_matches_jax(p, reduction):
    x, y = _fields((4, 8, 6, 2), seed=11)
    want, got = _both(jm.lp_loss, tm.lp_loss, x, y, p=p, reduction=reduction)
    _close(got, want, 1e-5, f"lp_loss p={p} {reduction}")


@pytest.mark.parametrize("band", [(None, None), (0, 4), (4, 8), (8, None)],
                         ids=["all", "low", "mid", "high"])
def test_fft_losses_match_jax(band):
    x, y = _fields((3, 16, 16, 1), seed=12)
    for p in (2, 3):
        want, got = _both(jm.fft_lp_loss, tm.fft_lp_loss, x, y, flow=band[0], fhigh=band[1],
                          p=p)
        _close(got, want, 1e-4, f"fft_lp_loss p={p} {band}")
    for reduction in ("mean", "sum"):
        want, got = _both(jm.fft_mse_loss, tm.fft_mse_loss, x, y, flow=band[0],
                          fhigh=band[1], reduction=reduction)
        _close(got, want, 1e-4, f"fft_mse_loss {reduction} {band}")


def test_inverse_metrics_match_jax():
    u0, x = _fields((1, 32, 1), seed=13)
    pred_u0, y = _fields((1, 32, 1), seed=14)
    want, got = _both(jm.inverse_metrics, tm.inverse_metrics, u0, x, pred_u0, y)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], float)
        rtol = 1e-4 if k.startswith("fft") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_fourier_binning_is_the_same_bits_twice():
    """The one-hot product that bins the spectral error gives the same bits
    on every call."""
    pred, tgt = (torch.from_numpy(a) for a in _fields((2, 32, 32, 3, 2), seed=15))
    a = tm.metric_func(pred, tgt, if_mean=False)[5]
    b = tm.metric_func(pred, tgt, if_mean=False)[5]
    assert torch.equal(a, b)
