"""Time the probe and the attention kernels above head dim 128 of two
checkouts side by side on the card, by one method in the same profiler
sessions.

    python -m sciml_pde_torch.experiments.checkout_comparison OTHER

``OTHER`` is the root of another checkout of the repo (an earlier commit,
unpacked with ``git archive``).  This builds ``csrc/probe.cu`` and
``csrc/attention.cu`` of this checkout and of ``OTHER``, the other's
kernels renamed (``_kernel`` to ``_pkernel``) so that a profiler session
tells the two apart, and times

- the probe kernel of each at (8, 128) f32, and ``torch.mul(x, 2)``;
- the forward, dQ and dK/dV of each at (4, 1280, 512), in bf16 and f32;
- the forward, dQ and dK/dV of each at (8, 1280, 256) in f32 (each tree's
  body of that head dim: ``_key_256``);
- the forward, dQ and dK/dV of each at (2, 256, 1032), in bf16 and f32
  (each tree's body above head dim 1024: ``_key_wide``);

in profiler device time (``profiler_ms``: the median of three sessions in
which the two checkouts' launches, and the probe's with ``torch.mul``'s,
take turns) and in CUDA events (each alone, this checkout's first, then
the other's, then both again in reverse order).  Each line also gives the
largest difference between the two checkouts' outputs, absolute and over
the largest magnitude of the other's.  Needs the card and
nvcc; prints the card's name and power limit and one line per kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from sciml_pde_torch.ops import _build
from sciml_pde_torch.ops import attention as ta
from sciml_pde_torch.utils.profiling import cuda_ms, profiler_ms

TREES = ("this", "other")
KEY_SUFFIX = {"this": "_kernel", "other": "_pkernel"}
SHAPE = (4, 1280, 512)
SHAPE_256 = (8, 1280, 256)
SHAPE_WIDE = (2, 256, 1032)
PROBE_REPS = 200
HBM_BPS = 3.35e12  # H100 SXM data-sheet HBM rate: the probe's bound (bytes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launcher(f, args: tuple, what: str):
    f.restype = ctypes.c_int

    def launch():
        if f(*args) != 0:
            raise RuntimeError(f"{what} failed")
    return launch


def _key_256(text: str, short: str, suffix: str) -> str:
    """The profiler key of the f32 kernel that ``short`` ("fwd", "dq" or
    "dkv") launches at head dim 256 in the tree whose attention.cu is
    ``text``: its split-TF32 body of two warpgroups where the tree has one
    (``fwd_tf32w_kernel``), else its CUDA-core body (``fwd_kernel``)."""
    tf32w = f"{short}_tf32w{suffix}"
    return f"{tf32w}<" if tf32w in text else f"{short}{suffix}<"


def _key_wide(text: str, short: str, suffix: str) -> str:
    """The profiler key of the kernel that ``short`` ("fwd", "dq" or "dkv")
    launches above head dim 1024 in the tree whose attention.cu is
    ``text``: its tensor-core body where the tree has one
    (``fwd_wide_tc_kernel``), else its CUDA-core body
    (``fwd_wide_cc_kernel``)."""
    tc = f"{short}_wide_tc{suffix}"
    return f"{tc}<" if tc in text else f"{short}_wide_cc{suffix}<"


def _report(card: str, what: str, launches: dict, keys: dict, outs: dict, reps: int,
            bound_ms: float = 0.0, extra=None) -> None:
    """Print the device and event times of both checkouts' ``launches``
    (and of ``extra``: (name, fn, key), interleaved with them)."""
    def both():
        for t in TREES:
            launches[t]()
        if extra:
            extra[1]()

    dev = {t: profiler_ms(both, keys[t], reps=reps, bound_ms=bound_ms, sessions=3)
           for t in TREES}
    ev = {t: [] for t in TREES}
    for t in (*TREES, *reversed(TREES)):
        ev[t].append(cuda_ms(launches[t]))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(outs["this"], outs["other"]))
    rel = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
              for a, b in zip(outs["this"], outs["other"]))
    line = (f"[compare] {card}: {what}: profiler device time (median of three sessions) "
            + "; ".join(f"{t} {dev[t]} ms" for t in TREES))
    if extra:
        line += (f"; {extra[0]} "
                 f"{profiler_ms(both, extra[2], reps=reps, bound_ms=bound_ms, sessions=3)} ms")
    line += ("; events " + "; ".join(f"{t} {', '.join(f'{x:.4f}' for x in ev[t])} ms"
                                     for t in TREES)
             + f"; largest difference between the outputs {diff:.3e} ({rel:.3e} of the "
             "largest magnitude)")
    print(line, flush=True)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the comparison times kernels on the card", file=sys.stderr)
        return 2
    other = Path(argv[0]) / "sciml_pde_torch" / "ops" / "csrc"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    texts = {}
    for src in ("probe", "attention"):
        texts[(src, "this")] = (_build.CSRC / f"{src}.cu").read_text()
        texts[(src, "other")] = (other / f"{src}.cu").read_text().replace("_kernel", "_pkernel")
    stream = _P(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_copies(texts, Path(tmp))
        print(f"[compare] {card}: built probe.cu and attention.cu of both checkouts", flush=True)

        x = torch.randn(8, 128, generator=torch.Generator().manual_seed(8)).cuda()
        outs = {t: torch.empty_like(x) for t in TREES}
        launches = {t: _launcher(libs[("probe", t)].probe_double,
                                 (_P(x.data_ptr()), _P(outs[t].data_ptr()), _I(x.numel()),
                                  stream), f"probe_double of {t}")
                    for t in TREES}
        _report(card, "probe (8, 128) f32", launches,
                {t: "probe" + KEY_SUFFIX[t] for t in TREES},
                {t: [outs[t]] for t in TREES}, PROBE_REPS, bound_ms=2 * x.numel() * 4 / HBM_BPS
                * 1e3, extra=("torch.mul", lambda: torch.mul(x, 2), "elementwise_kernel"))

        g = torch.Generator().manual_seed(3)
        for (bh, n, d), dt in ((SHAPE, torch.bfloat16), (SHAPE, torch.float32),
                               (SHAPE_256, torch.float32), (SHAPE_WIDE, torch.bfloat16),
                               (SHAPE_WIDE, torch.float32)):
            q, k, v, do = (torch.randn(bh, n, d, generator=g).to("cuda", dt) for _ in range(4))
            scale = d**-0.5
            o, l = ta.attention_fwd_plain(q, k, v, scale)
            delta = torch.sum(do.float() * o.float(), -1, keepdim=True)
            tail = (_I(bh), _I(n), _I(d), _I(int(dt == torch.bfloat16)), _F(scale), stream)
            for short, fname in (("fwd", "attention_fwd"), ("dq", "attention_dq"),
                                 ("dkv", "attention_dkv")):
                outs = {t: [torch.empty_like(q), torch.empty_like(l)] if short == "fwd"
                        else [torch.empty_like(q) for _ in range(1 if short == "dq" else 2)]
                        for t in TREES}
                ins = (q, k, v) if short == "fwd" else (q, k, v, do, l, delta)
                launches = {t: _launcher(getattr(libs[("attention", t)], fname),
                                         (*(_P(a.data_ptr()) for a in (*ins, *outs[t])), *tail),
                                         f"{fname} of {t}")
                            for t in TREES}
                keys = {t: (_key_wide(texts[("attention", t)], short, KEY_SUFFIX[t])
                            if d > ta.CLUSTER_MAX_D else f"{short}_wide{KEY_SUFFIX[t]}<"
                            if d > 256 else _key_256(texts[("attention", t)], short, KEY_SUFFIX[t]))
                        for t in TREES}
                _report(card, f"{fname} {(bh, n, d)} {str(dt)[6:]} ({', '.join(keys.values())})",
                        launches, keys, outs, 20)
            del q, k, v, do, o, l, delta
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
