"""Spectral convolution (the FNO hot path), PyTorch port of
``sciml_pde_tpu/ops/spectral.py``.

Semantics: real FFT over the two spatial axes, a complex channel mix on the
retained corner mode blocks (rows ``[:m1]`` and ``[H-m1:]``, columns
``[:m2]`` of the rfft axis), zero elsewhere, inverse real FFT.  Arrays are
channels-last ``(B, H, W, C)`` and complex weights are ``(2, Cin, Cout, m1,
m2)`` real/imag stacks, as in the JAX package.

``impl="dft"`` never forms the full spectrum: the forward transform is a
partial DFT (two skinny products with constant factor matrices) and the
inverse is the adjoint pair with Hermitian doubling along the rfft axis.
``impl="dft2"`` packs each complex contraction of that chain into one real
contraction with the block factor [[Br, Bi], [-Bi, Br]] (the real
embedding of complex multiplication): five products per layer instead of
fourteen (seven instead of 22 in 3D, ``spectral_conv_3d``).  ``impl="fft"``
goes through ``torch.fft`` for cross-checking.
The module default is ``dft2``, or ``SCIML_SPECTRAL_IMPL={dft,dft2,fft}``
as in the JAX package; ``impl=None`` means the module default.

Precision: ``SCIML_DFT_PRECISION={highest,high,default}`` as in the JAX
package, default ``default``: bf16 inputs to every DFT/mode product with
f32 accumulation.  ``highest`` (and ``high``) keep f32 inputs.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_PRECISIONS = ("highest", "high", "default")


def _parse_precision(name: str) -> str:
    name = name.lower()
    if name not in _PRECISIONS:
        raise ValueError(f"unknown dft precision {name!r}; one of {_PRECISIONS}")
    return name


_PRECISION = _parse_precision(os.environ.get("SCIML_DFT_PRECISION", "default"))


def set_dft_precision(name: str) -> None:
    global _PRECISION
    _PRECISION = _parse_precision(name)


def get_dft_precision() -> str:
    return _PRECISION


_IMPLS = ("dft", "dft2", "fft")
_DEFAULT_IMPL = os.environ.get("SCIML_SPECTRAL_IMPL", "dft2").lower()


def set_spectral_impl(name: str) -> None:
    """Set the process-wide default impl ("dft" | "dft2" | "fft")."""
    global _DEFAULT_IMPL
    if name.lower() not in _IMPLS:
        raise ValueError(f"unknown spectral impl {name!r}")
    _DEFAULT_IMPL = name.lower()


def get_spectral_impl() -> str:
    return _DEFAULT_IMPL


def dot_bf16() -> bool:
    """True when products take bf16 inputs (the ``default`` precision)."""
    return _PRECISION == "default"


def round_dot_input(x: torch.Tensor, bf16: bool | None = None) -> torch.Tensor:
    """``x`` rounded to bf16 and back when products take bf16 inputs."""
    if dot_bf16() if bf16 is None else bf16:
        return x.to(torch.bfloat16).float()
    return x


@functools.lru_cache(maxsize=128)
def _dft_factors_1d(n: int, modes: int, rows: tuple[int, ...] | None):
    """Partial-DFT bases along one axis of length n, as (real, imag) f32
    numpy pairs.

    ``rows`` None: retained frequencies 0..modes-1 (the rfft axis);
      fwd (n, modes) e^{-2 pi i k x / n}; inv (modes, n) c_k e^{+2 pi i k x / n} / n
      with Hermitian doubling c_0 = 1, c_k = 2 for 0 < k < n/2, c_{n/2} = 1.
    Else ``rows`` lists the retained (negative-wrapped) frequencies of a
    full-complex axis; inv has no doubling.
    """
    xs = np.arange(n)
    if rows is None:
        ks = np.arange(modes)
        ang_f = -2 * np.pi * np.outer(xs, ks) / n
        c = np.where((ks > 0) & (ks < n / 2), 2.0, 1.0)[:, None]
        ang_i = 2 * np.pi * np.outer(ks, xs) / n
        fwd = (np.cos(ang_f), np.sin(ang_f))
        inv = (c * np.cos(ang_i) / n, c * np.sin(ang_i) / n)
    else:
        ks = np.asarray(rows)
        ang_f = -2 * np.pi * np.outer(xs, ks) / n
        ang_i = 2 * np.pi * np.outer(ks, xs) / n
        fwd = (np.cos(ang_f), np.sin(ang_f))
        inv = (np.cos(ang_i) / n, np.sin(ang_i) / n)
    return (
        tuple(a.astype(np.float32) for a in fwd),
        tuple(a.astype(np.float32) for a in inv),
    )


def _corner_rows(n: int, m: int) -> tuple[int, ...]:
    """Frequencies [0..m-1] and [n-m..n-1] (the two corner blocks)."""
    return tuple(range(m)) + tuple(range(n - m, n))


# "dft2" factors: a complex contraction y = x @ F becomes one real
# contraction over a doubled axis with the block factor [[Fr, Fi], [-Fi, Fr]]:
# y_re = xr Fr - xi Fi, y_im = xr Fi + xi Fr.


@functools.lru_cache(maxsize=128)
def _dft2_real_axis(n: int, modes: int):
    """rfft-like axis of a REAL signal.  Returns (fwd, inv):
    fwd (n, 2, modes): real input -> stacked (re, im) mode axis;
    inv (2, modes, n): Hermitian-weighted inverse keeping only Re[output]."""
    (fr, fi), (ir, ii) = _dft_factors_1d(n, modes, None)
    fwd = np.stack([fr, fi], axis=1).astype(np.float32)  # "nsk"
    inv = np.stack([ir, -ii], axis=0).astype(np.float32)  # "skn"
    return fwd, inv


@functools.lru_cache(maxsize=128)
def _dft2_corner_axis(n: int, m: int):
    """Full-complex corner axis (rows [0..m-1] and [n-m..n-1]).  Returns
    (fwd, inv) block factors:
    fwd (2, n, 2, 2m): complex input (complexity s) x complex e^{-i...}
      -> complexity t on the 2m retained rows;
    inv (2, 2m, 2, n): the adjoint pair back to physical length n."""
    rows = _corner_rows(n, m)
    (fr, fi), (ir, ii) = _dft_factors_1d(n, 2 * m, rows)
    fwd = np.empty((2, n, 2, 2 * m), np.float32)
    fwd[0, :, 0] = fr
    fwd[0, :, 1] = fi
    fwd[1, :, 0] = -fi
    fwd[1, :, 1] = fr
    inv = np.empty((2, 2 * m, 2, n), np.float32)
    inv[0, :, 0] = ir
    inv[0, :, 1] = ii
    inv[1, :, 0] = -ii
    inv[1, :, 1] = ir
    return fwd, inv


def _weight_block(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, *modes) complex weight pair -> (2, Ci, 2, Co, *modes) block
    [[wr, wi], [-wi, wr]] (contraction over (t, Ci), output (u, Co))."""
    return torch.stack([torch.stack([wr, wi], dim=1), torch.stack([-wi, wr], dim=1)], dim=0)


@functools.lru_cache(maxsize=128)
def _device_factors(kind: str, n: int, m: int, device: torch.device):
    """The factor matrices of one axis as f32 tensors on ``device``, copied
    there once: a copy from host memory on every call would wait for the
    card's queue to drain."""
    if kind == "real":
        arrays = sum(_dft_factors_1d(n, m, None), ())
    elif kind == "corner":
        arrays = sum(_dft_factors_1d(n, 2 * m, _corner_rows(n, m)), ())
    elif kind == "dft2_real":
        arrays = _dft2_real_axis(n, m)
    elif kind == "dft2_corner":
        arrays = _dft2_corner_axis(n, m)
    else:
        raise KeyError(kind)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, bf16: bool | None = None) -> torch.Tensor:
    return torch.einsum(eq, round_dot_input(a, bf16), round_dot_input(b, bf16))


def _cmul_mm(ar, ai, br, bi, eq: str):
    """Complex multiply-contract via real einsums: (ar + i ai) x (br + i bi)."""
    rr = _einsum(eq, ar, br)
    if ai is None:  # real input (forward transform of a real signal)
        return rr, _einsum(eq, ar, bi)
    return rr - _einsum(eq, ai, bi), _einsum(eq, ar, bi) + _einsum(eq, ai, br)


def dft2_spectral_conv_2d(x, w1, w2, modes1: int, modes2: int,
                          bf16: bool | None = None) -> torch.Tensor:
    """The ``dft2`` chain: five real contractions, each with both inputs
    rounded to bf16 when ``bf16`` (None: the module precision) -- the
    mode-mix weight block too, as ``precision=`` rounds it in the JAX
    package.  Shapes as ``spectral_conv_2d``."""
    h, w = x.shape[1], x.shape[2]
    fw, vw = _device_factors("dft2_real", w, modes2, x.device)
    gh, gi = _device_factors("dft2_corner", h, modes1, x.device)
    # W-axis partial rDFT of the real signal -> complexity axis s
    xw = _einsum("bhwc,wsk->bhskc", x, fw, bf16)
    # H-axis corner DFT: contract (s, h) jointly -> complexity t
    xf = _einsum("bhskc,shtr->btrkc", xw, gh, bf16)
    # mode mix: contract (t, Cin) jointly -> (complexity u, Cout)
    w2b = _weight_block(torch.cat([w1[0], w2[0]], dim=2), torch.cat([w1[1], w2[1]], dim=2))
    yf = _einsum("btrkc,tcuork->burko", xf, w2b, bf16)
    # inverse H (complex), then the Hermitian-weighted real W inverse
    yh = _einsum("burko,urvh->bvhko", yf, gi, bf16)
    return _einsum("bvhko,vkw->bhwo", yh, vw, bf16)


def spectral_conv_2d(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    modes1: int,
    modes2: int,
    impl: str | None = None,
) -> torch.Tensor:
    """2D spectral convolution.

    x: (B, H, W, Cin) real; w1, w2: (2, Cin, Cout, modes1, modes2) real/imag
    stacks for the low (rows [:m1]) and high (rows [-m1:]) frequency blocks.
    Returns (B, H, W, Cout) real.  ``impl`` None: the module default.
    """
    impl = impl or _DEFAULT_IMPL
    h, w = x.shape[1], x.shape[2]
    if impl == "fft":
        xf = torch.fft.rfft2(x, dim=(1, 2))  # (B, H, W//2+1, Cin)
        w1c = torch.complex(w1[0], w1[1])
        w2c = torch.complex(w2[0], w2[1])
        top = torch.einsum("bxyi,ioxy->bxyo", xf[:, :modes1, :modes2], w1c)
        bot = torch.einsum("bxyi,ioxy->bxyo", xf[:, h - modes1:, :modes2], w2c)
        out_ft = torch.zeros(
            (x.shape[0], h, w // 2 + 1, top.shape[-1]), dtype=torch.complex64,
            device=x.device,
        )
        out_ft[:, :modes1, :modes2] = top
        out_ft[:, h - modes1:, :modes2] = bot
        return torch.fft.irfft2(out_ft, s=(h, w), dim=(1, 2))
    if impl == "dft2":
        return dft2_spectral_conv_2d(x, w1, w2, modes1, modes2)
    if impl != "dft":
        raise ValueError(f"unknown spectral impl {impl!r}")

    fwr, fwi, iwr, iwi = _device_factors("real", w, modes2, x.device)
    fhr, fhi, ihr, ihi = _device_factors("corner", h, modes1, x.device)
    # W-axis partial rDFT of the real signal: (B,H,W,C) @ (W,m2)
    xwr, xwi = _cmul_mm(x, None, fwr, fwi, "bhwc,wk->bhkc")
    # H-axis partial DFT on the retained corner rows -> (B, 2m1, m2, C)
    xfr, xfi = _cmul_mm(xwr, xwi, fhr, fhi, "bhkc,hr->brkc")
    # mode mix with the two corner-row weight blocks stacked along rows
    wr = torch.cat([w1[0], w2[0]], dim=2)  # (Ci, Co, 2m1, m2)
    wi = torch.cat([w1[1], w2[1]], dim=2)
    yfr, yfi = _cmul_mm(xfr, xfi, wr, wi, "brkc,cork->brko")
    # inverse H (complex), then the Hermitian-weighted real inverse W:
    # Re[(yr + i yi)(gr + i gi)] = yr gr - yi gi
    yhr, yhi = _cmul_mm(yfr, yfi, ihr, ihi, "brko,rh->bhko")
    return _einsum("bhko,kw->bhwo", yhr, iwr) - _einsum("bhko,kw->bhwo", yhi, iwi)


def _corner_grid(w1, w2, w3, w4, part: int) -> torch.Tensor:
    """The four 3D corner blocks on the (2m1, 2m2) corner grid: rows [:m1]
    +x and [m1:] -x, columns [:m2] +y and [m2:] -y -> (Ci, Co, 2m1, 2m2, m3)."""
    top = torch.cat([w1[part], w3[part]], dim=3)
    bot = torch.cat([w2[part], w4[part]], dim=3)
    return torch.cat([top, bot], dim=2)


def spectral_conv_3d(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    w3: torch.Tensor,
    w4: torch.Tensor,
    modes1: int,
    modes2: int,
    modes3: int,
    impl: str | None = None,
) -> torch.Tensor:
    """3D spectral convolution with the four corner blocks (+x, +y), (-x, +y),
    (+x, -y), (-x, -y), all at the low z modes of the rfft axis.

    x: (B, X, Y, Z, Cin) real; w*: (2, Cin, Cout, m1, m2, m3) real/imag
    stacks.  Returns (B, X, Y, Z, Cout) real.  ``dft2`` is seven real
    contractions, ``dft`` the partial-DFT chain (22 real products), both
    with the 2D conv's rounding of every product's inputs; ``fft`` goes
    through ``torch.fft``.  ``impl`` None: the module default."""
    impl = impl or _DEFAULT_IMPL
    nx, ny, nz = x.shape[1], x.shape[2], x.shape[3]
    if impl == "fft":
        xf = torch.fft.rfftn(x, dim=(1, 2, 3))  # (B, X, Y, Z//2+1, Cin)
        blocks = ((slice(0, modes1), slice(0, modes2), w1),
                  (slice(nx - modes1, nx), slice(0, modes2), w2),
                  (slice(0, modes1), slice(ny - modes2, ny), w3),
                  (slice(nx - modes1, nx), slice(ny - modes2, ny), w4))
        out_ft = torch.zeros((x.shape[0], nx, ny, nz // 2 + 1, w1.shape[2]),
                             dtype=torch.complex64, device=x.device)
        for sx, sy, w in blocks:
            out_ft[:, sx, sy, :modes3] = torch.einsum(
                "bxyzi,ioxyz->bxyzo", xf[:, sx, sy, :modes3], torch.complex(w[0], w[1]))
        return torch.fft.irfftn(out_ft, s=(nx, ny, nz), dim=(1, 2, 3))
    if impl == "dft2":
        fz, vz = _device_factors("dft2_real", nz, modes3, x.device)
        gy, gyi = _device_factors("dft2_corner", ny, modes2, x.device)
        gx, gxi = _device_factors("dft2_corner", nx, modes1, x.device)
        a = _einsum("bxyzc,zpk->bxypkc", x, fz)
        a = _einsum("bxypkc,pyqs->bxqskc", a, gy)
        a = _einsum("bxqskc,qxtr->btrskc", a, gx)
        w2b = _weight_block(_corner_grid(w1, w2, w3, w4, 0), _corner_grid(w1, w2, w3, w4, 1))
        a = _einsum("btrskc,tcuorsk->bursko", a, w2b)
        a = _einsum("bursko,urvx->bvxsko", a, gxi)
        a = _einsum("bvxsko,vswy->bwxyko", a, gyi)
        return _einsum("bwxyko,wkz->bxyzo", a, vz)
    if impl != "dft":
        raise ValueError(f"unknown spectral impl {impl!r}")

    fzr, fzi, izr, izi = _device_factors("real", nz, modes3, x.device)
    fxr, fxi, ixr, ixi = _device_factors("corner", nx, modes1, x.device)
    fyr, fyi, iyr, iyi = _device_factors("corner", ny, modes2, x.device)
    ar, ai = _cmul_mm(x, None, fzr, fzi, "bxyzc,zk->bxykc")
    ar, ai = _cmul_mm(ar, ai, fyr, fyi, "bxykc,ys->bxskc")
    ar, ai = _cmul_mm(ar, ai, fxr, fxi, "bxskc,xr->brskc")
    ar, ai = _cmul_mm(ar, ai, _corner_grid(w1, w2, w3, w4, 0), _corner_grid(w1, w2, w3, w4, 1),
                      "brskc,corsk->brsko")
    ar, ai = _cmul_mm(ar, ai, ixr, ixi, "brsko,rx->bxsko")
    ar, ai = _cmul_mm(ar, ai, iyr, iyi, "bxsko,sy->bxyko")
    return _einsum("bxyko,kz->bxyzo", ar, izr) - _einsum("bxyko,kz->bxyzo", ai, izi)


def spectral_weight_init(in_channels: int, out_channels: int, *modes: int,
                         generator: torch.Generator | None = None,
                         device=None) -> torch.Tensor:
    """Reference init: scale * U[0, 1) for real and imag, scale = 1/(Cin*Cout),
    as a (2, Cin, Cout, *modes) real stack (two mode counts in 2D, three in
    3D)."""
    scale = 1.0 / (in_channels * out_channels)
    shape = (2, in_channels, out_channels, *modes)
    return scale * torch.rand(shape, generator=generator, device=device)


def naive_spectral_conv_2d_numpy(x, w1c, w2c, m1, m2):
    """Numpy oracle for tests: direct translation of the math definition."""
    b, h, w, ci = x.shape
    co = w1c.shape[1]
    xf = np.fft.rfft2(x, axes=(1, 2))
    out = np.zeros((b, h, w // 2 + 1, co), dtype=np.complex128)
    out[:, :m1, :m2] = np.einsum("bxyi,ioxy->bxyo", xf[:, :m1, :m2], w1c)
    out[:, h - m1:, :m2] = np.einsum("bxyi,ioxy->bxyo", xf[:, h - m1:, :m2], w2c)
    return np.fft.irfft2(out, s=(h, w), axes=(1, 2))
