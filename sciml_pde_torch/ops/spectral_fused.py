"""One FNO layer as one fused op (port of ``sciml_pde_tpu/ops/spectral_fused.py``,
B6):

    y = gelu(spectral_conv_2d(x) + x @ pw + bias)

with the ``dft2`` spectral conv and the exact (erf) gelu, channels-last:
x (B, H, W, Ci), w1/w2 (2, Ci, Co, m1, m2), pw (Ci, Co), bias (Co,).

``spectral_fused_layer`` is the kernel's wrapper: on a CUDA device it
launches the two kernels of ``csrc/spectral_fused.cu`` (a thread-block
cluster per element that forms and mixes the corner spectrum, then the
inverse and the epilogue; one launch of the layer, counted once in
``LAUNCHES["spectral_fused"]``), on the CPU it runs
the plain version ``fused_fno_layer_2d_plain``; any other device raises,
and so does a failed build or launch.  ``plan`` lays out the two kernels'
shared memory for the shape (the only reckoning of it; the kernels take
it as it is): every layer the three kernels before the redesign took
fits, wide ones in passes or smaller tiles.  Both compute in f32 whatever
``SCIML_DFT_PRECISION`` says, as the JAX kernel does (its einsums take no
precision argument).

``fused_fno_layer_2d`` is the differentiable op: its forward is the
kernel, its backward autograd of the plain composition ``_layer_reference``
at the module's spectral impl and precision, as the JAX ``custom_vjp``
backs training with the XLA chain's VJP.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sciml_pde_torch.models.common import gelu
from sciml_pde_torch.ops import _build
from sciml_pde_torch.ops.fno_kernels import _need, _on_cuda
from sciml_pde_torch.ops.spectral import (
    _device_factors,
    dft2_spectral_conv_2d,
    spectral_conv_2d,
)

KERNEL_NAMES = ("spectral_fused",)
LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)
MAX_SMEM = 232448  # dynamic shared memory a block may use on Hopper
# csrc/spectral_fused.cu's launch shape: cluster ranks at most, threads of the
# spectrum kernel, rows of a streamed chunk and groups of its w-sum at most,
# rows of an inverse block at most
P_MAX, SPECTRUM_THREADS, CHUNK_ROWS, SPLIT_MAX, INVERSE_ROWS = 16, 1024, 4, 8, 2
# the fields of csrc/spectral_fused.cu's Plan, in its order
PLAN_FIELDS = ("H", "W", "C", "O", "M1", "K",
               "P", "HB", "R", "RB", "S", "KP", "RP", "RR", "MP",
               "fws", "xb", "cb", "xg", "xwp", "part", "smem1",
               "RT", "WT", "URC", "OP", "XS", "OS",
               "yfs", "gis", "vws", "pws", "bs", "yh", "xs", "os", "smem2")

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _layer_reference(x, w1, w2, pw, bias, modes1: int, modes2: int) -> torch.Tensor:
    """The plain composition at the module's impl and precision; its
    autograd is the fused op's backward."""
    y = spectral_conv_2d(x, w1, w2, modes1, modes2) + torch.einsum("bhwc,co->bhwo", x, pw) + bias
    return gelu(y)


def fused_fno_layer_2d_plain(x, w1, w2, pw, bias, modes1: int, modes2: int) -> torch.Tensor:
    """What the kernel computes: the dft2 chain, x @ pw, bias and the erf
    gelu, every product in f32."""
    y = (dft2_spectral_conv_2d(x, w1, w2, modes1, modes2, bf16=False)
         + torch.einsum("bhwc,co->bhwo", x, pw) + bias)
    return gelu(y)


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _halvings(n: int) -> list[int]:
    """n, ceil(n / 2), ceil(n / 4), ... down to 1."""
    out = [n]
    while out[-1] > 1:
        out.append(-(-out[-1] // 2))
    return out


def chunk_split(ci: int, kp: int, rows: int = CHUNK_ROWS) -> int:
    """Thread groups that split the w-sum of a chunk of ``rows`` rows at
    ``kp`` modes: as many as the spectrum kernel's threads hold beside the
    chunk's 4 x 4 tiles, at most SPLIT_MAX."""
    tiles = _up4(2 * kp) // 4 * -(-rows * ci // 4)
    return min(SPLIT_MAX, max(1, SPECTRUM_THREADS // tiles))


def _spectrum_plans(h: int, w: int, ci: int, m1: int, m2: int):
    """The spectrum kernel's layouts, in the order tried: every corner row
    and mode in one pass with chunks of 4, 2, then 1 row, then fewer groups
    of the w-sum, then passes over halves, quarters, ... of the modes, then
    of the corner rows."""
    band = -(-h // P_MAX)
    p = -(-h // band)
    for rp in (2 * q for q in _halvings(m1)):
        rr = -(-rp // p)
        for kp in _halvings(m2):
            mp, kc = _up4(2 * kp), kp * ci
            sizes = [(rb, chunk_split(ci, kp, rb)) for rb in (CHUNK_ROWS, 2, 1)]
            sizes += [(1, s) for s in _halvings(sizes[-1][1])[1:]]
            for rb, s in sizes:
                xg = _up4(rb * w * ci)
                cb = xg + rb * 4 * rp
                xb = w * mp
                xwp = xb + _up4(max(2 * cb, 2 * rr * kc))
                part = xwp + _up4(s * rb * 2 * kc)
                yield {"P": p, "HB": band, "R": 2 * m1, "RB": rb, "S": s, "KP": kp, "RP": rp,
                       "RR": rr, "MP": mp, "fws": 0, "xb": xb, "cb": cb, "xg": xg, "xwp": xwp,
                       "part": part, "smem1": 4 * (part + _up4(2 * rp * kc))}


def _inverse_plans(w: int, ci: int, co: int, m1: int, m2: int):
    """The inverse kernel's layouts, in the order tried: blocks of 2, then
    1 row over all columns, then halves, quarters, ... of the columns, then
    the corner rows staged in halves, quarters, ..."""
    op, u = _up4(co), 4 * m1
    for urc in _halvings(u):
        for wt in _halvings(w):
            for rt in (INVERSE_ROWS, 1):
                xs_row, os_row = _up4(wt * ci), _up4(wt * co)
                gis = urc * m2 * op
                vws = gis + rt * 2 * u
                pws = vws + 2 * m2 * _up4(wt)
                bs = pws + ci * op
                yh = bs + op
                xs = yh + rt * 2 * m2 * op
                os_ = xs + rt * xs_row
                yield {"RT": rt, "WT": wt, "URC": urc, "OP": op, "XS": xs_row, "OS": os_row,
                       "yfs": 0, "gis": gis, "vws": vws, "pws": pws, "bs": bs, "yh": yh,
                       "xs": xs, "os": os_, "smem2": 4 * (os_ + rt * os_row)}


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, ci: int, co: int, m1: int, m2: int) -> dict[str, int]:
    """The two kernels' layout at this layer shape (csrc/spectral_fused.cu's
    Plan): the first of each kernel's layouts that fits MAX_SMEM.  Raises
    ValueError where even the smallest does not."""
    fits = {}
    for name, plans in (("spectrum", _spectrum_plans(h, w, ci, m1, m2)),
                        ("inverse", _inverse_plans(w, ci, co, m1, m2))):
        for cand in plans:
            if cand["smem1" if name == "spectrum" else "smem2"] <= MAX_SMEM:
                fits.update(cand)
                break
        else:
            raise ValueError(f"the layer ({h} x {w}, {ci} -> {co} channels, modes {m1}, {m2}): "
                             f"the {name} kernel's smallest layout needs more than the "
                             f"{MAX_SMEM} bytes of shared memory a block has")
    return {"H": h, "W": w, "C": ci, "O": co, "M1": m1, "K": m2, **fits}


@functools.lru_cache(maxsize=64)
def plan_ints(h: int, w: int, ci: int, co: int, m1: int, m2: int) -> ctypes.Array:
    """``plan`` as the ints of csrc/spectral_fused.cu's Plan, in its order."""
    pl = plan(h, w, ci, co, m1, m2)
    return (_I * len(PLAN_FIELDS))(*(pl[f] for f in PLAN_FIELDS))


def max_clusters(h: int, w: int, ci: int, co: int, m1: int, m2: int) -> int:
    """The most clusters of the spectrum kernel at this layer shape that the
    card holds at once (``cudaOccupancyMaxActiveClusters``).  Needs the
    card."""
    f = _build.load("spectral_fused").spectral_fused_max_clusters
    f.argtypes, f.restype = [ctypes.POINTER(_I), _I, ctypes.POINTER(_I)], ctypes.c_int
    out = _I(0)
    rc = f(plan_ints(h, w, ci, co, m1, m2), len(PLAN_FIELDS), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"spectral_fused_max_clusters: CUDA error {rc}")
    return out.value


def spectral_fused_layer(x, w1, w2, pw, bias, modes1: int, modes2: int) -> torch.Tensor:
    """The fused layer's forward: the CUDA kernels on the card, the plain
    version on the CPU."""
    if not _on_cuda(x, w1, w2, pw, bias):
        return fused_fno_layer_2d_plain(x, w1, w2, pw, bias, modes1, modes2)
    b, h, w, ci = x.shape
    co = pw.shape[1]
    _need(x, (b, h, w, ci), what="x")
    for name, t in (("w1", w1), ("w2", w2)):
        _need(t, (2, ci, co, modes1, modes2), what=name)
    _need(pw, (ci, co), what="pw")
    _need(bias, (co,), what="bias")
    ints = plan_ints(h, w, ci, co, modes1, modes2)
    global _fn
    if _fn is None:
        f = _build.load("spectral_fused").spectral_fused_forward
        f.argtypes = [_P] * 11 + [_I, ctypes.POINTER(_I), _I, _P]
        f.restype = ctypes.c_int
        _fn = f
    fw, vw = _device_factors("dft2_real", w, modes2, x.device)
    gh, gi = _device_factors("dft2_corner", h, modes1, x.device)
    yf = torch.empty(b, 2, 2 * modes1, modes2, _up4(co), device=x.device)
    out = torch.empty(b, h, w, co, device=x.device)
    ptrs = (x, w1, w2, pw, bias, fw, gh, gi, vw, yf, out)
    rc = _fn(*(_P(t.data_ptr()) for t in ptrs), b, ints, len(PLAN_FIELDS),
             _P(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"spectral_fused: CUDA error {rc} at launch")
    LAUNCHES["spectral_fused"] += 1
    return out


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, pw, bias, modes1, modes2):
        ctx.save_for_backward(x, w1, w2, pw, bias)
        ctx.modes = (modes1, modes2)
        return spectral_fused_layer(x, w1, w2, pw, bias, modes1, modes2)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(_layer_reference(*ins, *ctx.modes), ins, g)
        return (*grads, None, None)


def fused_fno_layer_2d(x, w1, w2, pw, bias, modes1: int, modes2: int) -> torch.Tensor:
    """gelu(spectral_conv2d(x, w1, w2) + x @ pw + bias), the forward fused."""
    return _FusedLayer.apply(x, w1, w2, pw, bias, modes1, modes2)
