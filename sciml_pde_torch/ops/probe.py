"""Native-kernel probe (port of the Pallas probe in
``experiments/spectral_impl_bench.py::probe_pallas_native``, B7).

``probe(x)`` doubles an f32 tensor: on a CUDA device through the CUDA
kernel of ``csrc/probe.cu`` (one 16-byte vector a thread), on the CPU
through its plain version
``probe_plain``.  Any other device raises, and so does a failed build or
launch.  Every launch adds one to ``LAUNCHES["probe"]``.  Its use is to show
that the build and launch path works on the card before anything is built
on it (``experiments/spectral_impl_bench.py::probe_native``).
"""

from __future__ import annotations

import ctypes

import torch

from sciml_pde_torch.ops import _build
from sciml_pde_torch.ops.fno_kernels import _on_cuda

KERNEL_NAMES = ("probe",)
LAUNCHES: dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)
MAX_ELEMENTS = 1 << 20  # a probe: a few tensors of a few elements

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` for a contiguous f32 tensor of 1 to ``MAX_ELEMENTS`` elements."""
    if not _on_cuda(x):
        return probe_plain(x)
    if x.dtype != torch.float32 or not 0 < x.numel() <= MAX_ELEMENTS:
        raise ValueError(f"probe takes f32 with 1 to {MAX_ELEMENTS} elements, got "
                         f"{x.dtype} {tuple(x.shape)}")
    global _fn
    if _fn is None:
        f = _build.load("probe").probe_double
        f.argtypes, f.restype = [_P, _P, _I, _P], ctypes.c_int
        _fn = f
    out = torch.empty_like(x)
    rc = _fn(_P(x.data_ptr()), _P(out.data_ptr()), x.numel(),
             _P(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe: CUDA error {rc} at launch")
    LAUNCHES["probe"] += 1
    return out
