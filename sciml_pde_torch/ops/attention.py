"""Fused softmax attention (port of ``sciml_pde_tpu/ops/attention.py``).

Three wrappers, each beside its plain PyTorch version, launch the CUDA
kernels of ``csrc/attention.cu`` for tensors on a CUDA device and run the
plain version for tensors on the CPU; any other device raises, and so does
a failed build or launch.  Every launch adds one to ``LAUNCHES[name]``.

  attention_fwd   (q, k, v) -> o, l                      B3 ``_fwd_kernel``
  attention_dq    (q, k, v, do, l, delta) -> dq          B4 ``_dq_kernel``
  attention_dkv   (q, k, v, do, l, delta) -> dk, dv      B5 ``_dkv_kernel``

on flat ``(BH, N, D)`` panels in f32 or bf16, any head dim ``D % 8 == 0`` up
to 256 and any ``BH``; ``l`` (the row logsumexp) and ``delta = rowsum(do *
o)`` are ``(BH, N, 1)`` f32.  The bf16 kernels run their products on the
tensor cores (``p`` and ``ds`` split into two bf16 terms each), the f32
kernels on the CUDA cores (see the source's note).  The plain versions
compute the Pallas bodies over whole rows: inputs widened to f32, ``q``
scaled in f32, ``p`` and ``ds`` kept in f32, outputs rounded to the input
type once.

``flash_attention`` on ``(B, H, N, D)`` takes these kernels through an
``autograd.Function`` for the shapes the JAX package sends to its Pallas
kernels and ``jnp_attention`` (softmax probabilities rounded to the input
type) for every other shape, by the JAX package's own rule.
"""

from __future__ import annotations

import ctypes

import torch

from sciml_pde_torch.ops import _build
from sciml_pde_torch.ops.fno_kernels import _on_cuda

MAX_PALLAS_TOKENS = 2048
BLOCK_Q = 256
BLOCK_K = 256
# csrc/attention.cu is built for the padded head dims 16, 32, 64, 96, 128,
# 160, 192 and 256 and takes any head dim d % 8 == 0 up to MAX_HEAD_DIM
MAX_HEAD_DIM = 256
# rows per block: 64, or 32 above head dim 128 (the f32 dQ and dK/dV tiles;
# the bf16 kernels take two blocks per 64-row tile there); the blocks of all
# (bh, tile) pairs lie on grid.x
TILE = 64

KERNEL_NAMES = ("attention_fwd", "attention_dq", "attention_dkv")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "attention_dq": [_P] * 7 + [_I] * 4 + [_F, _P],
    "attention_dkv": [_P] * 8 + [_I] * 4 + [_F, _P],
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data do not start on 16 bytes (the
    bf16 kernels copy 16-byte rows by cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, tensors, bh: int, n: int, d: int, bf: bool, scale: float) -> None:
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.load("attention"), name)
        f.argtypes = _SIGNATURES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    rc = f(*(_P(t.data_ptr()) for t in tensors), bh, n, d, int(bf), _F(scale),
           _P(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _check(q, panels=(), rows=()):
    """Validate the contiguous (BH, N, D) panels (q's dtype, f32 or bf16) and
    the contiguous f32 (BH, N, 1) rows for the kernels; returns (bh, n, d,
    bf16)."""
    bh, n, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernels take f32 or bf16, got {q.dtype}")
    for ts, shape, dtype in ((panels, (bh, n, d), q.dtype), (rows, (bh, n, 1), torch.float32)):
        for t in ts:
            if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"attention kernels: expected contiguous {shape} {dtype}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
    if not q.is_contiguous():
        raise ValueError("attention kernels: q must be contiguous")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head dims d % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    tiles = -(-n // TILE) * (2 if d > 128 else 1)
    if bh * tiles >= 2**31:
        raise ValueError(f"batch*heads {bh} x {tiles} row tiles exceed the kernels' "
                         "grid of 2^31 - 1 blocks")
    return bh, n, d, q.dtype == torch.bfloat16


def _scores(q, k, scale):
    """f32 scores of the Pallas bodies: q.astype(f32) * scale, then q.k^T."""
    return torch.matmul(q.float() * scale, k.float().transpose(-1, -2))


# ---------------------------------------------------------------------------
# B3 forward
# ---------------------------------------------------------------------------


def attention_fwd_plain(q, k, v, scale: float):
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e / denom, v.float()).to(q.dtype)
    return o, m + torch.log(denom)


def attention_fwd(q, k, v, scale: float):
    """(BH, N, D) q, k, v -> o (BH, N, D) in q's dtype, l (BH, N, 1) f32."""
    if not _on_cuda(q, k, v):
        return attention_fwd_plain(q, k, v, scale)
    bh, n, d, bf = _check(q, (k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    l = torch.empty(bh, n, 1, dtype=torch.float32, device=q.device)
    _launch("attention_fwd", (q, k, v, o, l), bh, n, d, bf, scale)
    return o, l


# ---------------------------------------------------------------------------
# B4 dQ and B5 dK/dV
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, do, l, delta, scale):
    p = torch.exp(_scores(q, k, scale) - l)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta)


def attention_dq_plain(q, k, v, do, l, delta, scale: float):
    _, ds = _p_ds(q, k, v, do, l, delta, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def attention_dq(q, k, v, do, l, delta, scale: float):
    """dq (BH, N, D) in q's dtype."""
    if not _on_cuda(q, k, v, do, l, delta):
        return attention_dq_plain(q, k, v, do, l, delta, scale)
    bh, n, d, bf = _check(q, (k, v, do), (l, delta))
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dq = torch.empty_like(q)
    _launch("attention_dq", (q, k, v, do, l, delta, dq), bh, n, d, bf, scale)
    return dq


def attention_dkv_plain(q, k, v, do, l, delta, scale: float):
    p, ds = _p_ds(q, k, v, do, l, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def attention_dkv(q, k, v, do, l, delta, scale: float):
    """dk, dv (BH, N, D) in q's dtype."""
    if not _on_cuda(q, k, v, do, l, delta):
        return attention_dkv_plain(q, k, v, do, l, delta, scale)
    bh, n, d, bf = _check(q, (k, v, do), (l, delta))
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("attention_dkv", (q, k, v, do, l, delta, dk, dv), bh, n, d, bf, scale)
    return dk, dv


# ---------------------------------------------------------------------------
# autograd and the public entry
# ---------------------------------------------------------------------------


class _FlashCore(torch.autograd.Function):
    """o = attention(q, k, v) on flat panels; the backward forms
    delta = rowsum(do * o) in f32 and runs dQ and dK/dV.  ``plain`` runs the
    plain versions on any device (the reference the card checks use)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        o, l = (attention_fwd_plain if plain else attention_fwd)(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, l)
        ctx.scale, ctx.plain = scale, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        dq_fn, dkv_fn = ((attention_dq_plain, attention_dkv_plain) if ctx.plain
                         else (attention_dq, attention_dkv))
        dq = dq_fn(q, k, v, do, l, delta, ctx.scale)
        dk, dv = dkv_fn(q, k, v, do, l, delta, ctx.scale)
        return dq, dk, dv, None, None


def jnp_attention(q, k, v, scale: float):
    """The JAX package's reference path on (B, H, N, D): scores in the input
    dtype, f32 softmax, probabilities rounded to the input dtype."""
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention(q, k, v, scale: float, plain: bool = False):
    """Fused attention on (B, H, N, D).  Shapes the JAX package's Pallas
    kernels do not take go to ``jnp_attention``, as there.  ``plain=True``
    computes the fused path through the plain versions on any device."""
    b, h, n, d = q.shape
    good = (
        n <= MAX_PALLAS_TOKENS
        and d % 8 == 0
        and (n % BLOCK_Q == 0 or n <= BLOCK_Q)
        and n % 8 == 0
    )
    if not good:
        return jnp_attention(q, k, v, scale)
    flat = lambda t: t.reshape(b * h, n, d).contiguous()  # noqa: E731
    out = _FlashCore.apply(flat(q), flat(k), flat(v), float(scale), plain)
    return out.reshape(b, h, n, d)
