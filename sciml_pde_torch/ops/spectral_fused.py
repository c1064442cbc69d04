"""One FNO layer as one fused op (port of ``sciml_pde_tpu/ops/spectral_fused.py``,
B6):

    y = gelu(spectral_conv_2d(x) + x @ pw + bias)

with the ``dft2`` spectral conv and the exact (erf) gelu, channels-last:
x (B, H, W, Ci), w1/w2 (2, Ci, Co, m1, m2), pw (Ci, Co), bias (Co,).

``spectral_fused_layer`` is the kernel's wrapper: on a CUDA device it
launches the three kernels of ``csrc/spectral_fused.cu`` (one launch of the
layer, counted once in ``LAUNCHES["spectral_fused"]``), on the CPU it runs
the plain version ``fused_fno_layer_2d_plain``; any other device raises,
and so does a failed build or launch.  Both compute in f32 whatever
``SCIML_DFT_PRECISION`` says, as the JAX kernel does (its einsums take no
precision argument).

``fused_fno_layer_2d`` is the differentiable op: its forward is the
kernel, its backward autograd of the plain composition ``_layer_reference``
at the module's spectral impl and precision, as the JAX ``custom_vjp``
backs training with the XLA chain's VJP.
"""

from __future__ import annotations

import ctypes

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
ROW_TILE = 4  # rows per block (SF_TH in csrc/spectral_fused.cu)
MAX_SMEM = 232448  # dynamic shared memory a block may use on Hopper

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


def _smem_bytes(w: int, ci: int, co: int, m1: int, m2: int) -> tuple[int, int, int]:
    """Dynamic shared memory of the partial-DFT, mix and inverse kernels."""
    r, t = 2 * m1, ROW_TILE
    part = t * w * ci + w * 2 * m2 + 2 * t * 2 * r + t * 2 * m2 * ci
    inv = 2 * r * m2 * co + 2 * m2 * w + 2 * r * 2 * t + t * 2 * m2 * co + t * w * ci + ci * co + co
    return 4 * part, 4 * 2 * m2 * ci, 4 * inv


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
    if max(_smem_bytes(w, ci, co, modes1, modes2)) > MAX_SMEM:
        raise ValueError(f"the layer ({w} columns, {ci} -> {co} channels, modes {modes1}, "
                         f"{modes2}) needs more shared memory than a block has")
    global _fn
    if _fn is None:
        f = _build.load("spectral_fused").spectral_fused_forward
        f.argtypes, f.restype = [_P] * 12 + [_I] * 7 + [_P], ctypes.c_int
        _fn = f
    fw, vw = _device_factors("dft2_real", w, modes2, x.device)
    gh, gi = _device_factors("dft2_corner", h, modes1, x.device)
    nt = -(-h // ROW_TILE)
    part = torch.empty(b, nt, 2, 2 * modes1, modes2, ci, device=x.device)
    yf = torch.empty(b, 2, 2 * modes1, modes2, co, device=x.device)
    out = torch.empty(b, h, w, co, device=x.device)
    ptrs = (x, w1, w2, pw, bias, fw, gh, gi, vw, part, yf, out)
    rc = _fn(*(_P(t.data_ptr()) for t in ptrs), b, h, w, ci, co, modes1, modes2,
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
