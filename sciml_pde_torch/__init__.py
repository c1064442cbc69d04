"""sciml_pde_torch: the PyTorch / CUDA (Hopper) port of ``sciml_pde_tpu``.

Module names follow the JAX package so that each counterpart is easy to
find.  The package imports ``torch`` and never JAX or ``sciml_pde_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``cpu`` they raise.

Every TPU kernel the port has taken (the fused FNO-2D step, flash
attention, the fused dft2 layer, the native-kernel probe) is hand-written
CUDA C++ for ``sm_90a`` (``ops/csrc``), built with ``nvcc`` at first use
(``ops/_build.py``).
"""

from sciml_pde_torch._device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
