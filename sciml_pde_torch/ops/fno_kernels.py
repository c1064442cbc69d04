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

# outer_partial_kernel (fno_bwd.cu): warps a block (OP_WARPS), the most
# persistent blocks (OP_GRID, one partial row each), Bm channels a chunk
# (OP_BT), A's m16 tiles a warp (OP_MW), pixels a tile (OP_PIX), its
# 16-pixel units (OP_UNITS), copy buffers (OP_STAGES), a copied row's
# pitch in elements (OP_LD) and a row of the k slices' sums (OP_RLD)
OUTER_WARPS, OUTER_GRID, OUTER_BT, OUTER_MW = 4, 396, 32, 4
OUTER_PIX, OUTER_UNITS, OUTER_STAGES, OUTER_LD, OUTER_RLD = 64, 4, 3, 72, 40
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
    "fno_wdft": ("fno_fwd", [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _P]),
    "fno_corner": ("fno_fwd", [_P] * 10 + [_I] * 10 + [_P]),
    "fno_iwdft_pw": ("fno_fwd", [_P] * 7 + [_I] * 11 + [_P]),
    "fno_head_fwd": ("fno_fwd", [_P] * 8 + [_I] * 9 + [_P]),
    "fno_head_bwd": ("fno_bwd", [_P] * 8 + [_I] * 9 + [_P]),
    "fno_mix_wgrad": ("fno_bwd", [_P] * 6 + [_I] * 5 + [_P]),
    "fno_outer_partial": ("fno_bwd", [_P, _P, _I, _I, _P] + [_I] * 10 + [_P]),
    "fno_reduce_rows": ("fno_bwd", [_P, _P, _I, _I, _P]),
    "fno_head_fwd_smem": ("fno_fwd", [_I] * 4, ctypes.c_longlong),
    "fno_wdft_smem": ("fno_fwd", [_I] * 5, ctypes.c_longlong),
    "fno_corner_smem": ("fno_fwd", [_I] * 5, ctypes.c_longlong),
    "fno_iwdft_smem": ("fno_fwd", [_I] * 5, ctypes.c_longlong),
    "fno_head_bwd_smem": ("fno_bwd", [_I] * 4, ctypes.c_longlong),
    "fno_outer_smem": ("fno_bwd", [_I], ctypes.c_longlong),
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
    (wdft, the attention bodies) or load them as vectors (mix_wgrad) move
    16 bytes at a time."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _need(t: torch.Tensor, shape, dtype=torch.float32, what: str = "tensor") -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


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
    if max(b * x * -(-y // 2), b * c * (hp * wp - x * y)) >= 2**31:  # 32-bit thread indices
        raise ValueError(f"lift: {(b, c, hp, wp)} has 2^31 or more pixel pairs or pad values")
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


WDFT_ROWS = 32    # rows of x a block owns (WD_ROWS, fno_fwd.cu)
WDFT_KC_MAX = 16  # k16 steps a chunk of N at most (WD_KC_MAX, fno_fwd.cu)


def _widest(fits, n: int) -> int:
    """The largest m <= n with fits(m), 0 when there is none; fits holds up
    to some m and fails above it (a layout's bytes grow with m)."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _balanced(n: int, most: int, step: int) -> int:
    """The chunk, a multiple of ``step`` up to ``most`` (itself a multiple of
    ``step``), that cuts n into the fewest chunks of about equal size."""
    c = min(_up(n, step), most)
    return _up(-(-n // -(-n // c)), step)


def wdft_smem_bytes(n: int, j: int, tc: bool, pre_size: int, kc: int) -> int:
    """Shared memory of one ``wdft_kernel`` block (``WdftLayout``,
    fno_fwd.cu) for N = n, J = j and chunks of at most ``kc`` k16 steps, on
    the tensor-core body with ``tc``; ``pre_size`` is the bytes of one pre
    value where gelu'(pre) is taken, 0 otherwise.  A mirror of the library's
    ``fno_wdft_smem``, which chip_smoke.py phase 3 holds it to."""
    ks, nnt = -(-n // 16), -(-j // 8)
    nch = -(-ks // kc)
    kcb = -(-ks // nch)
    nc = 16 * kcb
    ldx = n if nch == 1 else nc
    ts = _up(WDFT_ROWS * ldx, 8)
    buf = _up((n if nch == 1 else nc) * j, 4) * 4 + ts * 4
    if pre_size and nch == 1:
        buf += _up(ts * pre_size, 16)
    total = (2 if nch > 1 else 1) * buf + _up(WDFT_ROWS * j * 4, 16)
    if tc:
        total += WDFT_ROWS * (nc + 8) * 2 + kcb * nnt * 32 * 8
    return total


def wdft_plan(n: int, j: int, tc: bool, pre_size: int) -> int:
    """The chunk ``wdft_kernel`` streams N in: the most k16 steps (up to
    WDFT_KC_MAX) whose layout fits SMEM_MAX.  Shared memory grows with J
    only, so every N fits; past the widest J of this variant (787 on the
    tensor cores, 892 on the CUDA cores at any N above 16) it raises,
    naming that J."""
    kcs = range(min(-(-n // 16), WDFT_KC_MAX), 0, -1)
    for kc in kcs:
        if wdft_smem_bytes(n, j, tc, pre_size, kc) <= SMEM_MAX:
            return kc
    need = min(wdft_smem_bytes(n, j, tc, pre_size, kc) for kc in kcs)
    widest = _widest(lambda m: min(wdft_smem_bytes(n, m, tc, pre_size, kc) for kc in kcs)
                     <= SMEM_MAX, j)
    raise ValueError(f"wdft: J = {j} at N = {n} needs {need} bytes of shared memory a block, "
                     f"above {SMEM_MAX}; this variant takes J up to {widest}")


def wdft(x, fac, pre=None, gelu_grad=False, bf=False, gelu_in=False):
    if not _on_cuda(x, fac, pre):
        return wdft_plain(x, fac, pre, gelu_grad, bf, gelu_in)
    n, j = fac.shape
    if x.shape[-1] != n:
        raise ValueError(f"wdft: x {tuple(x.shape)} vs fac {tuple(fac.shape)}")
    if x.dtype != torch.float32 or fac.dtype != torch.float32 or (
            pre is not None and pre.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("wdft: x and fac must be f32, pre f32 or bf16")
    kc = wdft_plan(n, j, bool(bf), pre.element_size() if pre is not None and gelu_grad else 0)
    m = x.numel() // n
    x, fac, pre = _aligned(x), _aligned(fac), _aligned(pre)
    out = torch.empty(*x.shape[:-1], j, device=x.device)
    dpre = None
    if pre is not None:
        _need(pre, x.shape, pre.dtype, "pre")
        dpre = torch.empty_like(x)
    _launch("fno_wdft", "fno_wdft" if pre is None else "fno_wdft.adj", x, fac, out, m, n, j,
            pre, int(pre is not None and pre.dtype == torch.bfloat16), int(gelu_grad),
            dpre, int(gelu_in), int(bf), kc)
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


CORNER_CLUSTER = 4  # blocks a (element, W-mode) cluster, along H (CN_CLUSTER, fno_fwd.cu)
CORNER_HC_MAX = 64  # rows of H a chunk at most
CORNER_W_SMEM = 64 * 1024  # largest slice of W staged in shared memory (CN_W_SMEM)


def corner_smem_bytes(cin: int, cout: int, r: int, hc: int, tc: bool) -> int:
    """Shared memory of one ``corner_kernel`` block (``CornerLayout``,
    fno_fwd.cu) for chunks of ``hc`` rows of H, on the tensor-core path with
    ``tc``.  A mirror of the library's ``fno_corner_smem`` (chip_smoke.py
    phase 3 holds it to that)."""
    es, pad = (2, 8) if tc else (4, 4)
    mi, mo, kr = _up(cin, 16), _up(cout, 16), _up(2 * r, 16)
    wsm = 2 * cin * -(-cout // CORNER_CLUSTER) * r * 4
    chunk = (_up(mi * (kr + 4) * 4, 16) + _up(cin * 2 * r * 4, 16)
             + _up(mo * (kr + pad) * es, 16)
             + _up(cin * 2 * hc * 4, 16) + 2 * _up(2 * hc * r * 4, 16)
             + (_up(wsm, 16) if wsm <= CORNER_W_SMEM else 0))
    stage1 = _up(mi * (2 * hc + pad) * es, 16) + _up(2 * hc * (kr + pad) * es, 16)
    stage3 = _up(kr * (2 * hc + pad) * es, 16)
    return chunk + max(stage1, stage3)


def corner_plan(cin: int, cout: int, hp: int, r: int, tc: bool) -> int:
    """The chunk of H rows (a multiple of 8) ``corner_kernel`` takes a
    block's share of Hp in: balanced chunks of at most CORNER_HC_MAX rows,
    fewer where the layout would pass SMEM_MAX.  Shared memory grows with C
    and R only; past the widest C at this R (Cin = Cout) it raises, naming
    that C."""
    hc = _balanced(-(-hp // CORNER_CLUSTER), CORNER_HC_MAX, 8)
    while hc > 8 and corner_smem_bytes(cin, cout, r, hc, tc) > SMEM_MAX:
        hc -= 8
    need = corner_smem_bytes(cin, cout, r, hc, tc)
    if need <= SMEM_MAX:
        return hc
    widest = _widest(lambda m: corner_smem_bytes(m, m, r, 8, tc) <= SMEM_MAX, max(cin, cout))
    raise ValueError(f"corner: Cin = {cin}, Cout = {cout} at R = {r} need {need} bytes of shared "
                     f"memory a block, above {SMEM_MAX}; it takes C up to {widest} at this R")


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
    hc = corner_plan(cin, cout, hp, r, bool(bf))
    spr = torch.empty(b, cin, k, r, device=a.device, dtype=spec_dtype)
    spi = torch.empty_like(spr)
    d = None if spec_only else torch.empty(b, cout, hp, k2, device=a.device)
    _launch("fno_corner", "fno_corner.adj" if adj else "fno_corner", a, p[0], p[1], w[0],
            w[1], q[0], q[1], spr, spi, d, b, cin, cout, hp, k, r, int(adj),
            int(spec_dtype == torch.bfloat16), int(bf), hc)
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


IWDFT_GRID = 264     # blocks iwdft_pw_kernel aims at (IW_GRID, fno_fwd.cu)
IWDFT_WC_MAX = 256  # columns of W a block at most


def iwdft_smem_bytes(cin: int, cout: int, k: int, wc: int, tc: bool) -> int:
    """Shared memory of one ``iwdft_pw_kernel`` block (``IwdftLayout``,
    fno_fwd.cu) for chunks of ``wc`` columns of W, on the tensor-core path
    with ``tc``.  A mirror of the library's ``fno_iwdft_smem`` (chip_smoke.py
    phase 3 holds it to that)."""
    es, pad = (2, 8) if tc else (4, 4)
    mo, kp = _up(cout, 16), _up(2 * k + cin, 16)
    raw = _up((cout * 2 * k + cin * wc) * 4, 16)
    return (_up(mo * (kp + pad) * es, 16) + _up(kp * (wc + pad) * es, 16) + 2 * raw
            + _up(2 * k * wc * 4, 16) + _up(mo * 4, 16))


def iwdft_plan(cin: int, cout: int, k: int, wp: int, nrow: int, tc: bool) -> tuple[int, int]:
    """(WC, RB) of ``iwdft_pw_kernel``: balanced chunks of W of at most
    IWDFT_WC_MAX columns (a multiple of 16), fewer where the layout would
    pass SMEM_MAX, and the rows a block takes so that about IWDFT_GRID
    blocks run.  Shared memory grows with C only; past the widest C
    (Cin = Cout) it raises, naming that C."""
    wc = _balanced(wp, IWDFT_WC_MAX, 16)
    while wc > 16 and iwdft_smem_bytes(cin, cout, k, wc, tc) > SMEM_MAX:
        wc -= 16
    need = iwdft_smem_bytes(cin, cout, k, wc, tc)
    if need > SMEM_MAX:
        widest = _widest(lambda m: iwdft_smem_bytes(m, m, k, 16, tc) <= SMEM_MAX,
                         max(cin, cout))
        raise ValueError(f"iwdft_pw: Cin = {cin}, Cout = {cout} at 2K = {2 * k} need {need} "
                         f"bytes of shared memory a block, above {SMEM_MAX}; it takes C up to "
                         f"{widest} at this K")
    return wc, max(1, -(-nrow * -(-wp // wc) // IWDFT_GRID))


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
    wc, rb = iwdft_plan(cin, cout, k2 // 2, wp, b * hp, bool(bf))
    out = torch.empty(b, cout, hp, wp, device=d.device)
    pre = (torch.empty(b, cout, hp, wp, device=d.device, dtype=pre_dtype)
           if pre_dtype is not None else None)
    _launch("fno_iwdft_pw", "fno_iwdft_pw.adj" if adj else "fno_iwdft_pw", d, z, xin, mw,
            bias, out, pre, int(pre_dtype == torch.bfloat16), int(gelu), b, cin, cout, hp,
            wp, k2 // 2, int(bf), wc, rb)
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
    if spr.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spec_r: expected f32 or bf16, got {spr.dtype}")
    dwr = torch.empty(c, o, k, r, device=spr.device)
    dwi = torch.empty_like(dwr)
    # the kernel moves up to 16 bytes at a time along k * r
    spr, spi, dcr, dci = (_aligned(t) for t in (spr, spi, dcr, dci))
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


def outer_rows(npix: int) -> int:
    """Partial rows ``outer_partial_kernel`` writes for ``npix`` pixels: one
    per persistent block, the fewest blocks up to OUTER_GRID that keep the
    rounds of OUTER_PIX-pixel tiles the same (``outer_grid``, fno_bwd.cu)."""
    tiles = -(-npix // OUTER_PIX)
    if tiles < 1:
        return 1
    return -(-tiles // -(-tiles // OUTER_GRID))


def outer_smem_bytes(na: int) -> int:
    """Shared memory of one ``outer_partial_kernel`` block (``OuterLayout``,
    fno_bwd.cu) at any nB and on either path: OUTER_STAGES copied tiles (nA
    + OUTER_BT rows of OUTER_LD floats), then the k slices' sums of the
    products and of A's rows.  A mirror of the library's ``fno_outer_smem``
    (chip_smoke.py phase 3 holds it to that)."""
    mt = -(-na // 16)
    ks = max(1, min(OUTER_UNITS, OUTER_WARPS // -(-mt // OUTER_MW)))
    red = OUTER_STAGES * _up((na + OUTER_BT) * OUTER_LD * 4, 16)
    return red + _up(ks * 16 * mt * OUTER_RLD * 4, 16) + ks * 16 * mt * 4


def _check_outer_smem(na: int) -> None:
    """Raise, naming the widest nA (197), when one block's shared memory
    would pass SMEM_MAX; Bm's channels are unbounded."""
    if outer_smem_bytes(na) <= SMEM_MAX:
        return
    widest = _widest(lambda m: outer_smem_bytes(m) <= SMEM_MAX, na)
    raise ValueError(f"outer: nA = {na} needs {outer_smem_bytes(na)} bytes of shared memory a "
                     f"block, above {SMEM_MAX}; it takes nA up to {widest}")


def outer(a, bm, gelu, nh, nw, bf):
    if not _on_cuda(a, bm):
        return outer_plain(a, bm, gelu, nh, nw, bf)
    bn, na, lha, lwa = a.shape
    nb, lhb, lwb = bm.shape[1:]
    if bm.shape[0] != bn or nh > min(lha, lhb) or nw > min(lwa, lwb):
        raise ValueError(f"outer: a {tuple(a.shape)} bm {tuple(bm.shape)} region {(nh, nw)}")
    if a.dtype != torch.float32 or bm.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("outer: a must be f32, bm f32 or bf16")
    _check_outer_smem(na)
    part = torch.empty(outer_rows(bn * nh * nw), na * nb + na, device=a.device)
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
