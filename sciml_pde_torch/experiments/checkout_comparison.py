"""Time the probe and the attention kernels above head dim 128 of two
checkouts side by side on the card, by one method in the same profiler
sessions.

    python -m sciml_pde_torch.experiments.checkout_comparison OTHER [PART ...]

``OTHER`` is the root of another checkout of the repo (an earlier commit,
unpacked with ``git archive``).  This builds ``csrc/probe.cu``,
``csrc/attention.cu`` and ``csrc/spectral_fused.cu`` of this checkout and
of ``OTHER`` (only those of the ``PART`` names given: ``probe``,
``attention``, ``spectral_fused``; all three by default), the other's
kernels renamed (``_kernel`` to ``_pkernel``) so that a profiler session
tells the two apart, and times

- the probe kernel of each at (8, 128) f32, and ``torch.mul(x, 2)``;
- the forward, dQ and dK/dV of each at (4, 1280, 512), in bf16 and f32;
- the forward, dQ and dK/dV of each at (8, 1280, 256) in f32 (each tree's
  body of that head dim: ``_key_256``);
- the forward, dQ and dK/dV of each at (2, 256, 1032), in bf16 and f32
  (each tree's body above head dim 1024: ``_key_wide``);
- the fused dft2 layer (B6) of each at the flagship layer shape (4, 130,
  130, 20), modes 12, f32: each of the tree's kernels (``_sf_kernels``)
  and their sum, each tree called with its own signature
  (``_sf_takes_part``: a tree from before the redesign takes a ``part``
  scratch array; ``_sf_takes_plan``: this one takes the wrapper's plan);

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
import re
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
# the fused dft2 layer at the flagship: (B, H, W, Ci, Co, modes1, modes2)
SF_SHAPE = (4, 130, 130, 20, 20, 12, 12)
PARTS = ("probe", "attention", "spectral_fused")
# a kernel's name in a CUDA source: __global__ void [__launch_bounds__(...)] name(
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
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


def _sf_kernels(text: str) -> list[str]:
    """The kernels of a tree's spectral_fused.cu (as renamed), in source
    order: each one's profiler key."""
    return GLOBAL.findall(text)


def _sf_takes_part(text: str) -> bool:
    """Whether a tree's ``spectral_fused_forward`` takes the ``part``
    scratch array (B, ceil(H / 4), 2, 2 m1, m2, Ci) of the three-kernel
    layer from before the redesign."""
    head = text[text.index("spectral_fused_forward("):]
    return "float* part" in head[:head.index(")")]


def _sf_takes_plan(text: str) -> bool:
    """Whether a tree's ``spectral_fused_forward`` takes the wrapper's plan
    (``ops/spectral_fused.py::plan``) in place of the shape's seven ints."""
    head = text[text.index("spectral_fused_forward("):]
    return "const int* plan" in head[:head.index(")")]


def _sf_launcher(lib, text: str, ins, out, stream, what: str):
    """One launch of a tree's fused layer on ``ins`` (x, w1, w2, pw, bias
    and the factors fw, gh, gi, vw) into ``out``, with the scratch and the
    shape its signature takes, allocated once (yf with its channels padded
    to a multiple of 4, as the redesigned kernels lay it out; an older tree
    uses the front of it)."""
    from sciml_pde_torch.ops import spectral_fused as sf

    x, w1 = ins[0], ins[1]
    b, h, w, ci = x.shape
    co, m1, m2 = out.shape[-1], w1.shape[3], w1.shape[4]
    scratch = [torch.empty(b, 2, 2 * m1, m2, -(-co // 4) * 4, device=x.device)]
    if _sf_takes_part(text):
        scratch.insert(0, torch.empty(b, -(-h // 4), 2, 2 * m1, m2, ci, device=x.device))
    f = lib.spectral_fused_forward
    ptrs = tuple(_P(t.data_ptr()) for t in (*ins, *scratch, out))
    if _sf_takes_plan(text):
        f.argtypes = [_P] * len(ptrs) + [_I, ctypes.POINTER(_I), _I, _P]
        shape = (b, sf.plan_ints(h, w, ci, co, m1, m2), len(sf.PLAN_FIELDS))
    else:
        f.argtypes = [_P] * len(ptrs) + [_I] * 7 + [_P]
        shape = (b, h, w, ci, co, m1, m2)
    return _launcher(f, (*ptrs, *shape, stream), what)


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
    parts = argv[1:] or list(PARTS)
    if not argv or any(p not in PARTS for p in parts):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the comparison times kernels on the card", file=sys.stderr)
        return 2
    other = Path(argv[0]) / "sciml_pde_torch" / "ops" / "csrc"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    texts = {}
    for src in parts:
        texts[(src, "this")] = (_build.CSRC / f"{src}.cu").read_text()
        texts[(src, "other")] = (other / f"{src}.cu").read_text().replace("_kernel", "_pkernel")
    stream = _P(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_copies(texts, Path(tmp))
        print(f"[compare] {card}: built {', '.join(p + '.cu' for p in parts)} of both "
              "checkouts", flush=True)
        if "probe" in parts:
            _compare_probe(card, libs, stream)
        if "attention" in parts:
            _compare_attention(card, libs, texts, stream)
        if "spectral_fused" in parts:
            _compare_spectral_fused(card, libs, texts, stream)
    return 0


def _compare_probe(card: str, libs: dict, stream) -> None:
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(8)).cuda()
    outs = {t: torch.empty_like(x) for t in TREES}
    launches = {t: _launcher(libs[("probe", t)].probe_double,
                             (_P(x.data_ptr()), _P(outs[t].data_ptr()), _I(x.numel()), stream),
                             f"probe_double of {t}")
                for t in TREES}
    _report(card, "probe (8, 128) f32", launches, {t: "probe" + KEY_SUFFIX[t] for t in TREES},
            {t: [outs[t]] for t in TREES}, PROBE_REPS,
            bound_ms=2 * x.numel() * 4 / HBM_BPS * 1e3,
            extra=("torch.mul", lambda: torch.mul(x, 2), "elementwise_kernel"))


def _compare_attention(card: str, libs: dict, texts: dict, stream) -> None:
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


def _compare_spectral_fused(card: str, libs: dict, texts: dict, stream) -> None:
    """The fused dft2 layer of both trees at SF_SHAPE: each launch in
    events, the outputs' difference, and each kernel's device time and
    their sum, the two trees' launches taking turns in the same sessions."""
    from sciml_pde_torch.ops.spectral import _device_factors

    b, h, w, ci, co, m1, m2 = SF_SHAPE
    g = torch.Generator().manual_seed(6)
    x = torch.randn(b, h, w, ci, generator=g).cuda()
    w1, w2 = ((torch.rand(2, ci, co, m1, m2, generator=g) / (ci * co)).cuda() for _ in range(2))
    pw = ((2 * torch.rand(ci, co, generator=g) - 1) * ci**-0.5).cuda()
    bias = ((2 * torch.rand(co, generator=g) - 1) * ci**-0.5).cuda()
    fw, vw = _device_factors("dft2_real", w, m2, x.device)
    gh, gi = _device_factors("dft2_corner", h, m1, x.device)
    ins = (x, w1, w2, pw, bias, fw, gh, gi, vw)
    outs = {t: [torch.empty(b, h, w, co, device=x.device)] for t in TREES}
    launches = {t: _sf_launcher(libs[("spectral_fused", t)], texts[("spectral_fused", t)], ins,
                                outs[t][0], stream, f"spectral_fused_forward of {t}")
                for t in TREES}
    what = f"spectral_fused {SF_SHAPE[:4]} -> {co}, modes {m1} f32"
    ev = {t: [] for t in TREES}
    for t in (*TREES, *reversed(TREES)):
        ev[t].append(cuda_ms(launches[t]))
    a, o = outs["this"][0].double(), outs["other"][0].double()
    diff = float((a - o).abs().max())
    print(f"[compare] {card}: {what}: events "
          + "; ".join(f"{t} {', '.join(f'{x:.4f}' for x in ev[t])} ms" for t in TREES)
          + f"; largest difference between the outputs {diff:.3e} "
          f"({diff / float(o.abs().max()):.3e} of the largest magnitude)", flush=True)
    for t in TREES:
        dev = {kern: profiler_ms(lambda: [launches[u]() for u in TREES], kern, sessions=3)
               for kern in _sf_kernels(texts[("spectral_fused", t)])}
        total = None if None in dev.values() else sum(dev.values())
        print(f"[compare] {card}: {what}: {t} tree's kernels, profiler device time (median of "
              "three sessions, both trees' launches in turns): "
              + "; ".join(f"{kern} {ms} ms" for kern, ms in dev.items())
              + f"; their sum {total} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
