"""The fused FNO-2D step's CUDA kernels: one wrapper per kernel, each beside
its plain PyTorch version.

A wrapper launches its kernel (``csrc/fno_fwd.cu``, ``csrc/fno_bwd.cu``)
for tensors on a CUDA device and runs the plain version for tensors on the
CPU; for any other device it raises.  There is no fallback: a failed
build or launch raises.  Every launch adds one to ``LAUNCHES[name]`` (the
adjoint use of a forward kernel counts under ``name + ".adj"``), so a run
can show which kernels it went through.

Layouts (channels-first, logical sizes; Hp = X + pad, Wp = Y + pad,
K = m2 rfft modes, R = 2*m1 corner rows):
  field        (B, C, Hp, Wp) f32
  W-spectrum   (B, C, Hp, 2K) f32, real parts then imaginary parts
  spectrum     (B, C, K, R) real and imaginary apart, in the dot dtype
  mix weights  (C, O, K, R) real and imaginary apart

``bf`` selects bf16 inputs to every product (f32 accumulation).  Constant
matrices arrive already rounded (see ``fno_fused_step``); the kernels and
the plain versions round activations where they enter a product.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from sciml_pde_torch.ops import _build

KERNEL_NAMES = (
    "fno_stats", "fno_lift", "fno_wdft", "fno_wdft.adj", "fno_corner",
    "fno_corner.adj", "fno_iwdft_pw", "fno_iwdft_pw.adj", "fno_head_fwd",
    "fno_head_bwd", "fno_mix_wgrad", "fno_outer_partial", "fno_reduce_rows",
)
LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)

OUTER_PB = 256  # pixels per block of outer_partial_kernel (fno_bwd.cu)
# pixels a tile and the most persistent blocks of head_bwd_kernel (HB_PIX,
# HB_GRID, fno_bwd.cu): one partial row a block
HEAD_BWD_PIX, HEAD_BWD_GRID = 64, 256
SMEM_MAX = 227 * 1024  # shared memory one block may take on an H100


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fno_stats": ("fno_fwd", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "fno_lift": ("fno_fwd", [_P] * 8 + [_I] * 9 + [_P]),
    "fno_wdft": ("fno_fwd", [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P]),
    "fno_corner": ("fno_fwd", [_P] * 10 + [_I] * 9 + [_P]),
    "fno_iwdft_pw": ("fno_fwd", [_P] * 7 + [_I] * 9 + [_P]),
    "fno_head_fwd": ("fno_fwd", [_P] * 8 + [_I] * 9 + [_P]),
    "fno_head_bwd": ("fno_bwd", [_P] * 8 + [_I] * 9 + [_P]),
    "fno_mix_wgrad": ("fno_bwd", [_P] * 6 + [_I] * 5 + [_P]),
    "fno_outer_partial": ("fno_bwd", [_P, _P, _I, _I, _P] + [_I] * 10 + [_P]),
    "fno_reduce_rows": ("fno_bwd", [_P, _P, _I, _I, _P]),
    "fno_head_fwd_smem": ("fno_fwd", [_I] * 4, ctypes.c_longlong),
    "fno_head_bwd_smem": ("fno_bwd", [_I] * 4, ctypes.c_longlong),
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        lib_name, argtypes, *restype = _SIGNATURES[name]
        f = getattr(_build.load(lib_name), name)
        f.argtypes = argtypes
        f.restype = restype[0] if restype else ctypes.c_int
        _fns[name] = f
    return f


def _launch(name: str, counter: str, *args) -> None:
    conv = [
        _P(a.data_ptr()) if isinstance(a, torch.Tensor) else (_P(None) if a is None else a)
        for a in args
    ]
    rc = _fn(name)(*conv, _P(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[counter] += 1


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); anything else raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cuda"}:
        for t in ts:
            if t is not None and not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or on the CPU, got {devs}")


def _aligned(t):
    """``t`` (or None), or a copy of it when its data do not start on 16
    bytes: the kernels that copy tensors into shared memory by cp.async
    (wdft, the bf16 attention bodies) move 16 bytes at a time."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _need(t: torch.Tensor, shape, dtype=torch.float32, what: str = "tensor") -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _rd(x: torch.Tensor, bf: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf else x


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _gelu_grad(x):
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return cdf + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


# ---------------------------------------------------------------------------
# fno_stats: instance-norm statistics
# ---------------------------------------------------------------------------


def stats_plain(win):
    """win (B, T, Cc, X, Y) -> mean, std (B, Cc): unbiased std + 1e-7."""
    n = win.shape[1] * win.shape[3] * win.shape[4]
    mean = win.mean(dim=(1, 3, 4))
    d = win - mean[:, None, :, None, None]
    std = torch.sqrt((d * d).sum(dim=(1, 3, 4)) / (n - 1)) + 1e-7
    return mean, std


def stats(win):
    if not _on_cuda(win):
        return stats_plain(win)
    b, t, cc, x, y = win.shape
    _need(win, win.shape, what="win")
    mean = torch.empty(b, cc, device=win.device)
    std = torch.empty(b, cc, device=win.device)
    _launch("fno_stats", "fno_stats", win, mean, std, b, t, cc, x * y)
    return mean, std


# ---------------------------------------------------------------------------
# fno_lift: normalise + grid + fc0 into the padded field
# ---------------------------------------------------------------------------


def lift_plain(win, grid2, mean, std, w0t, b0, hp, wp, bf):
    """-> h0 (B, C, Hp, Wp) zero in the pad, finp (B, F, X, Y) the lift input."""
    b, t, cc, x, y = win.shape
    xn = (win - mean[:, None, :, None, None]) / std[:, None, :, None, None]
    finp = torch.cat([xn.reshape(b, t * cc, x, y), grid2.expand(b, -1, -1, -1)], dim=1)
    h0l = torch.einsum("cf,bfxy->bcxy", w0t, _rd(finp, bf)) + b0[:, None, None]
    h0 = torch.zeros(b, w0t.shape[0], hp, wp, device=win.device)
    h0[:, :, :x, :y] = h0l
    return h0, finp


def lift(win, grid2, mean, std, w0t, b0, hp, wp, bf):
    if not _on_cuda(win, grid2, mean, std, w0t, b0):
        return lift_plain(win, grid2, mean, std, w0t, b0, hp, wp, bf)
    b, t, cc, x, y = win.shape
    c, f = w0t.shape
    if f != t * cc + 2:
        raise ValueError(f"lift: w0t {tuple(w0t.shape)} does not fit T*Cc+2={t * cc + 2}")
    if c * f * 4 > SMEM_MAX:  # lift_kernel keeps the (C, F) weights in shared memory
        raise ValueError(f"lift: C = {c} at F = {f} needs {c * f * 4} bytes of shared memory "
                         f"a block, above {SMEM_MAX}; it takes C up to {SMEM_MAX // (4 * f)}")
    _need(grid2, (2, x, y), what="grid2")
    h0 = torch.empty(b, c, hp, wp, device=win.device)
    finp = torch.empty(b, f, x, y, device=win.device)
    _launch("fno_lift", "fno_lift", win, grid2, mean, std, w0t, b0, h0, finp,
            b, t, cc, x, y, c, hp, wp, int(bf))
    return h0, finp


# ---------------------------------------------------------------------------
# fno_wdft: W-axis partial DFT (forward), or dpre + adjoint inverse-W
# ---------------------------------------------------------------------------


def wdft_plain(x, fac, pre=None, gelu_grad=False, bf=False, gelu_in=False):
    """out (..., J) = v (..., N) @ fac (N, J) with v = x (gelu(x) with
    ``gelu_in``), or with ``pre`` given v = dpre = x * gelu'(pre) (x itself
    unless ``gelu_grad``).  Returns out, or (out, dpre) when ``pre`` is
    given."""
    v = _gelu(x) if gelu_in else x
    if pre is not None and gelu_grad:
        v = x * _gelu_grad(pre.float())
    out = torch.matmul(_rd(v, bf), fac)
    return out if pre is None else (out, v)


WDFT_ROWS = 32  # rows of x a block owns (WD_ROWS, fno_fwd.cu)


def _widest(fits, n: int) -> int:
    """The largest m <= n with fits(m), 0 when there is none."""
    while n > 0 and not fits(n):
        n -= 1
    return n


def wdft_smem_bytes(n: int, j: int, tc: bool, pre_size: int) -> int:
    """Shared memory of one ``wdft_kernel`` block (``WdftLayout``,
    fno_fwd.cu) for N = n, J = j, on the tensor-core body with ``tc``;
    ``pre_size`` is the bytes of one staged pre value, 0 when pre is not
    staged (no gelu')."""
    ts = (WDFT_ROWS * n + 7) // 8 * 8
    ks, nnt = (n + 15) // 16, (j + 7) // 8
    total = (n * j + 3) // 4 * 16 + ts * 4 + (ts * pre_size + 15) // 16 * 16
    if tc:
        total += WDFT_ROWS * (16 * ks + 8) * 2 + ks * nnt * 32 * 8
        total += (WDFT_ROWS * j * 4 + 15) // 16 * 16
    return total


def _check_wdft_smem(n: int, j: int, tc: bool, pre_size: int) -> None:
    """Raise, naming the widest N this variant takes at this J, when one
    block's shared memory would pass SMEM_MAX (at J = 24: N up to 492 on the
    tensor cores with gelu' and an f32 pre, up to 1037 on the CUDA cores
    with no pre)."""
    if wdft_smem_bytes(n, j, tc, pre_size) <= SMEM_MAX:
        return
    widest = _widest(lambda m: wdft_smem_bytes(m, j, tc, pre_size) <= SMEM_MAX, n)
    raise ValueError(f"wdft: N = {n} at J = {j} needs {wdft_smem_bytes(n, j, tc, pre_size)} "
                     f"bytes of shared memory a block, above {SMEM_MAX}; this variant takes "
                     f"N up to {widest}")


def wdft(x, fac, pre=None, gelu_grad=False, bf=False, gelu_in=False):
    if not _on_cuda(x, fac, pre):
        return wdft_plain(x, fac, pre, gelu_grad, bf, gelu_in)
    n, j = fac.shape
    if x.shape[-1] != n:
        raise ValueError(f"wdft: x {tuple(x.shape)} vs fac {tuple(fac.shape)}")
    if x.dtype != torch.float32 or fac.dtype != torch.float32 or (
            pre is not None and pre.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("wdft: x and fac must be f32, pre f32 or bf16")
    _check_wdft_smem(n, j, bool(bf), pre.element_size() if pre is not None and gelu_grad else 0)
    m = x.numel() // n
    x, fac, pre = _aligned(x), _aligned(fac), _aligned(pre)
    out = torch.empty(*x.shape[:-1], j, device=x.device)
    dpre = None
    if pre is not None:
        _need(pre, x.shape, pre.dtype, "pre")
        dpre = torch.empty_like(x)
    _launch("fno_wdft", "fno_wdft" if pre is None else "fno_wdft.adj", x, fac, out, m, n, j,
            pre, int(pre is not None and pre.dtype == torch.bfloat16), int(gelu_grad),
            dpre, int(gelu_in), int(bf))
    return out if pre is None else (out, dpre)


# ---------------------------------------------------------------------------
# fno_corner: H-axis corner DFT -> mode mix -> inverse H
# ---------------------------------------------------------------------------


def corner_plain(a, p, w, q, adj, spec_dtype, bf, spec_only=False):
    """a (B, Cin, Hp, 2K); p = (pr, pi) (Hp, R); w = (wr, wi) (C, O, K, R);
    q = (qr, qi) (R, Hp).  Returns spec_r, spec_i (B, Cin, K, R) in
    ``spec_dtype`` and D (B, Cout, Hp, 2K), None with ``spec_only``.  The
    forward mixes with W, the adjoint (``adj``) with conj(W) transposed over
    its channel axes."""
    k = a.shape[-1] // 2
    ar, ai = _rd(a[..., :k], bf), _rd(a[..., k:], bf)
    pr, pi = p
    br = torch.einsum("bchk,hr->bckr", ar, pr) - torch.einsum("bchk,hr->bckr", ai, pi)
    bi = torch.einsum("bchk,hr->bckr", ar, pi) + torch.einsum("bchk,hr->bckr", ai, pr)
    if spec_only:
        return br.to(spec_dtype), bi.to(spec_dtype), None
    wr, wi = w
    if adj:
        wr, wi = wr.transpose(0, 1), -wi.transpose(0, 1)
    cr = torch.einsum("bikr,ijkr->bjkr", br, wr) - torch.einsum("bikr,ijkr->bjkr", bi, wi)
    ci = torch.einsum("bikr,ijkr->bjkr", br, wi) + torch.einsum("bikr,ijkr->bjkr", bi, wr)
    cr, ci = _rd(cr, bf), _rd(ci, bf)
    qr, qi = q
    dr = torch.einsum("bjkr,rh->bjhk", cr, qr) - torch.einsum("bjkr,rh->bjhk", ci, qi)
    di = torch.einsum("bjkr,rh->bjhk", cr, qi) + torch.einsum("bjkr,rh->bjhk", ci, qr)
    return br.to(spec_dtype), bi.to(spec_dtype), torch.cat([dr, di], dim=-1)


def corner(a, p, w, q, adj, spec_dtype, bf, spec_only=False):
    if not _on_cuda(a, *p, *w, *q):
        return corner_plain(a, p, w, q, adj, spec_dtype, bf, spec_only)
    b, cin, hp, k2 = a.shape
    k, r = k2 // 2, p[0].shape[1]
    c, o = w[0].shape[:2]
    cout = c if adj else o
    if (o if adj else c) != cin:
        raise ValueError(f"corner: a {tuple(a.shape)} vs w {tuple(w[0].shape)} (adj={adj})")
    for t, shape in ((p[0], (hp, r)), (p[1], (hp, r)), (q[0], (r, hp)), (q[1], (r, hp)),
                     (w[0], (c, o, k, r)), (w[1], (c, o, k, r))):
        _need(t, shape, what="corner factor/weight")
    if adj and spec_dtype != torch.float32:
        raise ValueError("corner: the adjoint spectrum is kept in f32")
    spr = torch.empty(b, cin, k, r, device=a.device, dtype=spec_dtype)
    spi = torch.empty_like(spr)
    d = None if spec_only else torch.empty(b, cout, hp, k2, device=a.device)
    _launch("fno_corner", "fno_corner.adj" if adj else "fno_corner", a, p[0], p[1], w[0],
            w[1], q[0], q[1], spr, spi, d, b, cin, cout, hp, k, r, int(adj),
            int(spec_dtype == torch.bfloat16), int(bf))
    return spr, spi, d


# ---------------------------------------------------------------------------
# fno_iwdft_pw: inverse W + 1x1 conv (+ bias, gelu, saved pre)
# ---------------------------------------------------------------------------


def iwdft_pw_plain(d, z, xin, mw, bias, gelu, pre_dtype, bf):
    """v (B, Cout, Hp, Wp) = D (B, Cout, Hp, 2K) @ Z (2K, Wp) + Mw (Cout, Cin) . xin
    (+ bias).  Returns (gelu(v) or v, v in ``pre_dtype`` or None)."""
    v = torch.matmul(_rd(d, bf), z) + torch.einsum("jc,bchw->bjhw", mw, _rd(xin, bf))
    if bias is not None:
        v = v + bias[:, None, None]
    pre = v.to(pre_dtype) if pre_dtype is not None else None
    return (_gelu(v) if gelu else v), pre


def iwdft_pw(d, z, xin, mw, bias, gelu, pre_dtype, bf, adj=False):
    if not _on_cuda(d, z, xin, mw, bias):
        return iwdft_pw_plain(d, z, xin, mw, bias, gelu, pre_dtype, bf)
    b, cout, hp, k2 = d.shape
    cin, wp = xin.shape[1], xin.shape[3]
    _need(z, (k2, wp), what="Z")
    _need(xin, (b, cin, hp, wp), what="xin")
    _need(mw, (cout, cin), what="Mw")
    if bias is not None:
        _need(bias, (cout,), what="bias")
    out = torch.empty(b, cout, hp, wp, device=d.device)
    pre = (torch.empty(b, cout, hp, wp, device=d.device, dtype=pre_dtype)
           if pre_dtype is not None else None)
    _launch("fno_iwdft_pw", "fno_iwdft_pw.adj" if adj else "fno_iwdft_pw", d, z, xin, mw,
            bias, out, pre, int(pre_dtype == torch.bfloat16), int(gelu), b, cin, cout, hp,
            wp, k2 // 2, int(bf))
    return out, pre


# ---------------------------------------------------------------------------
# fno_head_fwd: fc1 -> gelu -> fc2 -> de-norm
# ---------------------------------------------------------------------------


def head_smem_bytes(name: str):
    """(C, NH, Co, tc) -> the shared memory of one block of ``name``'s kernel
    ("head_fwd" or "head_bwd"), as the library lays it out
    (``HeadFwdLayout``, ``HeadBwdLayout``)."""
    f = _fn(f"fno_{name}_smem")
    return lambda c, nh, co, tc: f(c, nh, co, int(tc))


def _check_head_smem(name: str, smem_bytes, c: int, nh: int, co: int, tc: bool) -> None:
    """Raise, naming the widest C this kernel takes at this NH and Co on its
    path (``tc``: the tensor cores under `default`), when one block's shared
    memory (``smem_bytes(c, nh, co, tc)``) would pass SMEM_MAX."""
    need = smem_bytes(c, nh, co, tc)
    if need <= SMEM_MAX:
        return
    widest = _widest(lambda m: smem_bytes(m, nh, co, tc) <= SMEM_MAX, c)
    raise ValueError(f"{name}: C = {c}, NH = {nh}, Co = {co} needs {need} bytes of shared "
                     f"memory a block, above {SMEM_MAX}; it takes C up to {widest} at this "
                     f"NH and Co")


def head_fwd_plain(hf, w1t, b1, w2t, b2, mean, std, x, y, bf):
    """hf (B, C, Hp, Wp) last-layer output -> pred (B, Co, X, Y)."""
    bb = _rd(hf[:, :, :x, :y], bf)
    a = torch.einsum("jc,bcxy->bjxy", w1t, bb) + b1[:, None, None]
    t1 = _rd(_gelu(a), bf)
    out = torch.einsum("oj,bjxy->boxy", w2t, t1) + b2[:, None, None]
    return out * std[:, :, None, None] + mean[:, :, None, None]


def head_fwd(hf, w1t, b1, w2t, b2, mean, std, x, y, bf):
    if not _on_cuda(hf, w1t, b1, w2t, b2, mean, std):
        return head_fwd_plain(hf, w1t, b1, w2t, b2, mean, std, x, y, bf)
    b, c, hp, wp = hf.shape
    nh, co = w1t.shape[0], w2t.shape[0]
    _need(w1t, (nh, c), what="w1t")
    _need(b1, (nh,), what="b1")
    _need(w2t, (co, nh), what="w2t")
    _need(b2, (co,), what="b2")
    _need(mean, (b, co), what="mean")
    _need(std, (b, co), what="std")
    if x > hp or y > wp:
        raise ValueError(f"head_fwd: region {(x, y)} outside hf {tuple(hf.shape)}")
    _check_head_smem("head_fwd", head_smem_bytes("head_fwd"), c, nh, co, bool(bf))
    pred = torch.empty(b, co, x, y, device=hf.device)
    _launch("fno_head_fwd", "fno_head_fwd", hf, w1t, b1, w2t, b2, mean, std, pred,
            b, c, x, y, hp, wp, nh, co, int(bf))
    return pred


# ---------------------------------------------------------------------------
# fno_head_bwd (+ fno_reduce_rows): head recompute + backward
# ---------------------------------------------------------------------------


def head_bwd_rows(npix: int) -> int:
    """Partial rows ``head_bwd_kernel`` writes for ``npix`` pixels: one per
    persistent block, min(HEAD_BWD_GRID, tiles)."""
    return max(1, min(HEAD_BWD_GRID, -(-npix // HEAD_BWD_PIX)))


def head_bwd_plain(dpred, hf, w1t, b1, w2t, std, bf):
    """-> dh (B, C, Hp, Wp) (zero outside the logical region), dw1t, db1,
    dw2t, db2 summed over batch and pixels."""
    x, y = dpred.shape[2:]
    bb = _rd(hf[:, :, :x, :y], bf)
    dout = dpred * std[:, :, None, None]
    a = torch.einsum("jc,bcxy->bjxy", w1t, bb) + b1[:, None, None]
    t1 = _rd(_gelu(a), bf)
    dor = _rd(dout, bf)
    dw2t = torch.einsum("boxy,bjxy->oj", dor, t1)
    db2 = dout.sum(dim=(0, 2, 3))
    dp = torch.einsum("oj,boxy->bjxy", w2t, dor) * _gelu_grad(a)
    dpr = _rd(dp, bf)
    dw1t = torch.einsum("bjxy,bcxy->jc", dpr, bb)
    db1 = dp.sum(dim=(0, 2, 3))
    dh = torch.zeros_like(hf)
    dh[:, :, :x, :y] = torch.einsum("jc,bjxy->bcxy", w1t, dpr)
    return dh, dw1t, db1, dw2t, db2


def head_bwd(dpred, hf, w1t, b1, w2t, std, bf):
    if not _on_cuda(dpred, hf, w1t, b1, w2t, std):
        return head_bwd_plain(dpred, hf, w1t, b1, w2t, std, bf)
    b, c, hp, wp = hf.shape
    co, x, y = dpred.shape[1:]
    nh = w1t.shape[0]
    _need(dpred, (b, co, x, y), what="dpred")
    _need(w1t, (nh, c), what="w1t")
    _need(b1, (nh,), what="b1")
    _need(w2t, (co, nh), what="w2t")
    _need(std, (b, co), what="std")
    if x > hp or y > wp:
        raise ValueError(f"head_bwd: region {(x, y)} outside hf {tuple(hf.shape)}")
    _check_head_smem("head_bwd", head_smem_bytes("head_bwd"), c, nh, co, bool(bf))
    n1, n2, n3 = nh * c, nh * c + nh, nh * c + nh + co * nh
    dh = torch.empty_like(hf)  # the kernel writes all of it, zeros in the pad
    part = torch.empty(head_bwd_rows(b * x * y), n3 + co, device=hf.device)
    _launch("fno_head_bwd", "fno_head_bwd", dpred, hf, w1t, b1, w2t, std, dh, part,
            b, c, x, y, hp, wp, nh, co, int(bf))
    g = reduce_rows(part)
    return (dh, g[:n1].view(nh, c), g[n1:n2], g[n2:n3].view(co, nh), g[n3:])


# ---------------------------------------------------------------------------
# fno_mix_wgrad: mode-mix weight gradients
# ---------------------------------------------------------------------------


def mix_wgrad_plain(spr, spi, dcr, dci):
    """spec (B, C, K, R), dspec (B, O, K, R) -> dwr, dwi (C, O, K, R) with
    dwr + i dwi = sum_b conj(spec) * dspec."""
    xr, xi = spr.float(), spi.float()
    dwr = torch.einsum("bckr,bokr->cokr", xr, dcr) + torch.einsum("bckr,bokr->cokr", xi, dci)
    dwi = torch.einsum("bckr,bokr->cokr", xr, dci) - torch.einsum("bckr,bokr->cokr", xi, dcr)
    return dwr, dwi


def mix_wgrad(spr, spi, dcr, dci):
    if not _on_cuda(spr, spi, dcr, dci):
        return mix_wgrad_plain(spr, spi, dcr, dci)
    b, c, k, r = spr.shape
    o = dcr.shape[1]
    _need(spi, spr.shape, spr.dtype, "spec_i")
    _need(dcr, (b, o, k, r), what="dspec_r")
    _need(dci, (b, o, k, r), what="dspec_i")
    dwr = torch.empty(c, o, k, r, device=spr.device)
    dwi = torch.empty_like(dwr)
    _launch("fno_mix_wgrad", "fno_mix_wgrad", spr, spi, dcr, dci, dwr, dwi, b, c, o, k * r,
            int(spr.dtype == torch.bfloat16))
    return dwr, dwi


# ---------------------------------------------------------------------------
# fno_outer_partial (+ fno_reduce_rows): 1x1-conv and lift weight gradients
# ---------------------------------------------------------------------------


def outer_plain(a, bm, gelu, nh, nw, bf):
    """a (B, nA, ., .) f32, bm (B, nB, ., .) over the region [:nh, :nw] ->
    (sum_p a[i,p] g(bm[j,p]) as (nA, nB), sum_p a[i,p] as (nA,)),
    g = gelu when ``gelu`` else identity."""
    av = a[:, :, :nh, :nw]
    bv = bm[:, :, :nh, :nw].float()
    if gelu:
        bv = _gelu(bv)
    out = torch.einsum("bixy,bjxy->ij", _rd(av, bf), _rd(bv, bf))
    return out, av.sum(dim=(0, 2, 3))


def outer(a, bm, gelu, nh, nw, bf):
    if not _on_cuda(a, bm):
        return outer_plain(a, bm, gelu, nh, nw, bf)
    bn, na, lha, lwa = a.shape
    nb, lhb, lwb = bm.shape[1:]
    if bm.shape[0] != bn or nh > min(lha, lhb) or nw > min(lwa, lwb):
        raise ValueError(f"outer: a {tuple(a.shape)} bm {tuple(bm.shape)} region {(nh, nw)}")
    if a.dtype != torch.float32 or bm.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("outer: a must be f32, bm f32 or bf16")
    nblk = -(-bn * nh * nw // OUTER_PB)
    part = torch.empty(nblk, na * nb + na, device=a.device)
    _launch("fno_outer_partial", "fno_outer_partial", a, bm, int(bm.dtype == torch.bfloat16),
            int(gelu), part, bn, na, nb, nh, nw, lha, lwa, lhb, lwb, int(bf))
    g = reduce_rows(part)
    return g[: na * nb].view(na, nb), g[na * nb:]


# ---------------------------------------------------------------------------
# fno_reduce_rows
# ---------------------------------------------------------------------------


def reduce_rows_plain(part):
    return part.sum(dim=0)


def reduce_rows(part):
    if not _on_cuda(part):
        return reduce_rows_plain(part)
    nblk, n = part.shape
    _need(part, (nblk, n), what="partial")
    out = torch.empty(n, device=part.device)
    _launch("fno_reduce_rows", "fno_reduce_rows", part, out, nblk, n)
    return out


# The two sets of the same ten functions the fused step is composed of.
KERNELS = SimpleNamespace(
    stats=stats, lift=lift, wdft=wdft, corner=corner, iwdft_pw=iwdft_pw,
    head_fwd=head_fwd, head_bwd=head_bwd, mix_wgrad=mix_wgrad, outer=outer,
)
PLAIN = SimpleNamespace(
    stats=stats_plain, lift=lift_plain, wdft=wdft_plain, corner=corner_plain,
    iwdft_pw=lambda *a, adj=False: iwdft_pw_plain(*a), head_fwd=head_fwd_plain,
    head_bwd=head_bwd_plain, mix_wgrad=mix_wgrad_plain, outer=outer_plain,
)
