"""Serving export of a trained operator through ``torch.export`` (port of
``sciml_pde_tpu/utils/export.py``).

An operator is exported once as a ``.pt2`` artifact, its parameters baked
in and its shapes fixed to the example's, and reloaded anywhere torch
runs, with no model code, configuration or checkpoint layout needed:

    art = export_apply(lambda x, g: model(x, g), (x_example, grid_example))
    save_exported(art, "fno_ns.pt2")
    ...
    serve = load_exported("fno_ns.pt2")   # -> callable
    y = serve(x, grid)

A rollout exports the same way (``fn`` wrapping ``eval/rollout.py::
rollout_predict``): the artifact is the whole autoregressive unroll.

The hand-written CUDA kernels are not registered as ``torch.library`` ops,
so ``torch.export`` cannot trace them; ``export_apply`` calls ``fn`` once
and refuses a function that launched one, rather than export a plain
version in the kernel's place.  The plain production models (the dft2
spectral conv) export on either device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import torch

# JAX's platform names -> the torch device type that serves them
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda", "rocm": "cuda", "tpu": "cuda"}


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _kernel_launches() -> dict[str, int]:
    from sciml_pde_torch.ops import attention, fno_kernels, probe, spectral_fused

    out: dict[str, int] = {}
    for mod in (attention, fno_kernels, probe, spectral_fused):
        out.update(mod.LAUNCHES)
    return out


def export_apply(fn: Callable, example_args: Sequence,
                 platforms: Sequence[str] = ("cuda", "cpu")) -> torch.export.ExportedProgram:
    """Trace ``fn`` (a function of tensors; parameters it closes over become
    constants of the artifact) at ``example_args``.  The artifact runs on the
    device of ``example_args``, which ``platforms`` must name (``tpu`` and
    ``gpu`` name CUDA).  Raises RuntimeError when ``fn`` launches a
    hand-written kernel."""
    devs = {a.device.type for a in example_args if isinstance(a, torch.Tensor)}
    wanted = {_PLATFORMS.get(p, p) for p in platforms}
    if not devs <= wanted:
        raise ValueError(f"the example arguments are on {sorted(devs)}, not among the "
                         f"platforms {list(platforms)}")
    before = _kernel_launches()
    with torch.no_grad():
        fn(*example_args)
    launched = sorted(k for k, n in _kernel_launches().items() if n != before.get(k, 0))
    if launched:
        raise RuntimeError(
            f"fn launches the hand-written CUDA kernels {launched}, which are not "
            "registered as torch.library ops: torch.export cannot trace them, and the "
            "artifact must not carry their plain versions in their place")
    return torch.export.export(_Fn(fn), tuple(example_args))


def save_exported(art: torch.export.ExportedProgram, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(art, str(path))
    return path


def load_exported(path: str | Path) -> Callable:
    """The artifact at ``path`` as a callable of the example's shapes."""
    return torch.export.load(str(path)).module()
