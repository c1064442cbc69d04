"""Timing ablation of the fused dft2 layer's spectrum kernel on the card.

    python -m sciml_pde_torch.experiments.spectral_fused_ablation

``sf_spectrum_kernel`` (``ops/csrc/spectral_fused.cu``, B6) streams each
rank's band of rows in chunks (the W-axis rDFT and the band's share of the
corner DFT), then adds the ranks' shares of its corner rows through
distributed shared memory between two cluster barriers and takes the
complex mix of those rows.  This builds copies of the source with parts
removed (``variants``: the mix; the mix and the reduction; the chunks as
well), whose results are wrong, and times each copy's two kernels beside
the shipped source's in the same profiler sessions (``profiler_ms``: the
median of three sessions in which the copies' launches take turns) at the
flagship layer shape (4, 130, 130, 20), modes 12, f32.  The differences are
what each part costs.  Needs the card and nvcc; prints the card's name and
power limit and one line per copy.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from sciml_pde_torch.ops import _build
from sciml_pde_torch.ops import spectral_fused as sf
from sciml_pde_torch.ops.spectral import _device_factors
from sciml_pde_torch.utils.profiling import profiler_ms

SHAPE = (4, 130, 130, 20, 20, 12, 12)  # (B, H, W, Ci, Co, modes1, modes2)
# the loops each cut removes (its bound set to 0), in the order the copies
# add them
CUTS = {"mix": "i < nr * kp * OP;",
        "reduction": "i < 2 * nr * KC;",
        "chunks": "ch < nch;"}
KERNELS = ("sf_spectrum_kernel", "sf_inverse_kernel")
_P, _I = ctypes.c_void_p, ctypes.c_int


def variants(src: str) -> dict[str, str]:
    """The shipped source and the copies with the mix, then also the
    reduction, then also the chunk loop removed, each copy's kernels renamed
    (``_kernel`` to ``_v<i>_kernel``)."""
    out, text = {"shipped": src}, src
    for i, (name, loop) in enumerate(CUTS.items(), 1):
        if src.count(loop) != 1:
            raise ValueError(f"expected one {loop!r} in spectral_fused.cu")
        text = text.replace(loop, loop.split("<")[0] + "< 0;")
        out["no " + " / ".join(list(CUTS)[:i])] = text.replace("_kernel", f"_v{i}_kernel")
    return out


def keys(i: int) -> list[str]:
    """The profiler keys of copy i's two kernels."""
    return [k.replace("_kernel", f"_v{i}_kernel") if i else k for k in KERNELS]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation times kernels on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    b, h, w, ci, co, m1, m2 = SHAPE
    g = torch.Generator().manual_seed(6)
    x = torch.randn(b, h, w, ci, generator=g).cuda()
    w1, w2 = ((torch.rand(2, ci, co, m1, m2, generator=g) / (ci * co)).cuda() for _ in range(2))
    pw = ((2 * torch.rand(ci, co, generator=g) - 1) * ci**-0.5).cuda()
    bias = ((2 * torch.rand(co, generator=g) - 1) * ci**-0.5).cuda()
    fw, vw = _device_factors("dft2_real", w, m2, x.device)
    gh, gi = _device_factors("dft2_corner", h, m1, x.device)
    yf = torch.empty(b, 2, 2 * m1, m2, -(-co // 4) * 4, device=x.device)
    ints, ranks = sf.plan_ints(h, w, ci, co, m1, m2), sf.plan(h, w, ci, co, m1, m2)["P"]
    stream = _P(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_copies(variants((_build.CSRC / "spectral_fused.cu").read_text()),
                                   Path(tmp))
        launches = []
        for name, lib in libs.items():
            f = lib.spectral_fused_forward
            f.argtypes = [_P] * 11 + [_I, ctypes.POINTER(_I), _I, _P]
            f.restype = ctypes.c_int
            out = torch.empty(b, h, w, co, device=x.device)
            args = (*(_P(t.data_ptr()) for t in (x, w1, w2, pw, bias, fw, gh, gi, vw, yf, out)),
                    b, ints, len(sf.PLAN_FIELDS), stream)

            def launch(f=f, args=args, name=name):
                if f(*args) != 0:
                    raise RuntimeError(f"spectral_fused_forward of the {name!r} copy failed")
            launches.append(launch)

        def all_copies():
            for fn in launches:
                fn()

        for i, name in enumerate(libs):
            dev = [profiler_ms(all_copies, key, sessions=3) for key in keys(i)]
            print(f"[ablation] {card}: spectral_fused {SHAPE[:4]} -> {co}, modes {m1} f32, "
                  f"{name} ({ranks} ranks): profiler device time (median of "
                  "three sessions, the copies' launches in turns) "
                  + "; ".join(f"{k} {ms} ms" for k, ms in zip(keys(i), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
