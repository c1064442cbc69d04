"""The f32 attention forward, dQ and dK/dV at head dims 160-256 against
their control on the card.

    python -m sciml_pde_torch.experiments.tf32w_attention_control

From head dim 160 to 256 ``attention_fwd``, ``attention_dq`` and
``attention_dkv`` take f32 panels through ``fwd_tf32w_kernel``,
``dq_tf32w_kernel`` and ``dkv_tf32w_kernel`` (``ops/csrc/attention.cu``):
one block of two warpgroups per 96-query, 80-query or 64-key tile that
share each score through shared memory.  The control is the cluster route
of the wider head dims at P = 2: ``fwd_wide_kernel<float>``,
``dq_wide_kernel<float>`` and ``dkv_wide_kernel<float>``, clusters of two
blocks that add their partial scores through distributed shared memory,
reached by a copy of the source whose dispatch (``ATT_DISPATCH``) sends
f32 above head dim 128, not 256, to the cluster bodies.  Beside them stand
copies with the forward's blocks cut otherwise (``DESIGNS``: 64 query
rows, 8 warps, two blocks an SM at 160 and 192, or 80 query rows, 10
warps, where the shipped source has 96 rows, 12 warps, one block an SM).
This builds every copy
(``variants``; each copy's kernels renamed, ``_kernel`` to ``_v1_kernel``
and so on, so that a profiler session tells them apart), prints their
registers and spills, and at (8, 1280, d), d = 160, 192 and 256, checks
each copy's outputs against the exact result (the plain arithmetic in f64:
largest error over the largest magnitude, and whether a second launch
gives the same bits) and times them in the same profiler sessions
(``profiler_ms``: the median of three sessions in which the copies'
launches take turns) beside the f32 SDPA forward or backward.  Needs the
card and nvcc; prints the card's name and power limit and one line per
reading.
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

HEAD_DIMS = (160, 192, 256)
BH, N = 8, 1280
# the dispatch's floor of the cluster bodies, and the control's: f32 from
# head dim 136 up
FLOOR = "if ((d) > 256) return"
CONTROL_FLOOR = "if ((d) > 256 || (!(bf) && (d) > 128)) return"
ROWS = "constexpr int TW_ROWS = 96;"
BLOCKS = "__launch_bounds__(4 * TW_ROWS, 1)"
TF32W = ("fwd_tf32w", "dq_tf32w", "dkv_tf32w")
# each copy: its edits of the source (each text occurs once), and the
# kernels it launches at these head dims (forward, dQ, dK/dV)
DESIGNS = {
    "shipped": ((), TF32W),
    "cluster control": (((FLOOR, CONTROL_FLOOR),), ("fwd_wide", "dq_wide", "dkv_wide")),
    "64 query rows": (((ROWS, ROWS.replace("96", "64")),
                       (BLOCKS, BLOCKS.replace("1)", "DP == 256 ? 1 : 2)"))), TF32W),
    "80 query rows": (((ROWS, ROWS.replace("96", "80")),), TF32W),
}
FNAMES = ("attention_fwd", "attention_dq", "attention_dkv")
PASSES = {"attention_fwd": 6, "attention_dq": 9, "attention_dkv": 12}
TF32_FLOPS = 495e12  # H100 SXM data-sheet dense TF32 rate: the bound (operations)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def suffix(i: int) -> str:
    """The kernel-name suffix of copy i of DESIGNS (0: the shipped source)."""
    return "_kernel" if i == 0 else f"_v{i}_kernel"


def keys(i: int, name: str) -> dict[str, str]:
    """The profiler keys of copy i's forward, dQ and dK/dV kernels."""
    return {f: f"{kern}{suffix(i)}<" for f, kern in zip(FNAMES, DESIGNS[name][1])}


def variants(src: str) -> dict[str, str]:
    """Every copy of DESIGNS: the shipped source, and each other one with its
    edits made and its kernels renamed."""
    out = {}
    for i, (name, (edits, _)) in enumerate(DESIGNS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"expected one {old!r} in attention.cu")
            text = text.replace(old, new)
        out[name] = text.replace("_kernel", suffix(i)) if i else text
    return out


def exact(name: str, q, k, v, do, l, delta, scale: float):
    """The plain arithmetic in f64 (the checks' exact result)."""
    q, k, v, do = q.double(), k.double(), v.double(), do.double()
    s = (q * scale) @ k.transpose(-1, -2)
    if name == "attention_fwd":
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        return e / e.sum(-1, keepdim=True) @ v, m + torch.log(e.sum(-1, keepdim=True))
    p = torch.exp(s - l.double())
    ds = p * (do @ v.transpose(-1, -2) - delta.double())
    if name == "attention_dq":
        return (ds @ k * scale,)
    return ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the control times kernels on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "attention.cu").read_text()
    stream = _P(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_copies(variants(src), Path(tmp))
        for i, (name, lib) in enumerate(libs.items()):
            for kern, regs, st, ld, frame in _build.copy_ptxas(lib):
                if any(kern.startswith(k) for k in keys(i, name).values()) and (
                        "wide" not in kern or "float" in kern):
                    print(f"[control] {name}: {kern}: {regs} registers, {st} bytes spill "
                          f"stores, {ld} bytes spill loads, {frame} bytes stack frame",
                          flush=True)
        g = torch.Generator().manual_seed(3)
        for d in HEAD_DIMS:
            q, k, v, do = (torch.randn(BH, N, d, generator=g).cuda() for _ in range(4))
            scale = d**-0.5
            o, l = ta.attention_fwd_plain(q, k, v, scale)
            delta = torch.sum(do * o, -1, keepdim=True)
            tail = (_I(BH), _I(N), _I(d), _I(0), _F(scale), stream)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            q4, k4, v4 = (t[None].requires_grad_(True) for t in (q, k, v))
            o4 = sdpa(q4, k4, v4, scale=scale)
            bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), do[None],  # noqa: E731
                                              retain_graph=True)
            library = {"attention_fwd": lambda: sdpa(q[None], k[None], v[None], scale=scale),
                       "attention_dq": bwd, "attention_dkv": bwd}
            for fname in FNAMES:
                ins = (q, k, v) if fname == "attention_fwd" else (q, k, v, do, l, delta)
                want = exact(fname, q, k, v, do, l, delta, scale)
                passes = PASSES[fname]
                bound_ms = passes * 2 * BH * N * N * d / TF32_FLOPS * 1e3
                launches, errs = {}, {}
                for name, lib in libs.items():
                    outs = ([torch.empty_like(q), torch.empty_like(l)] if fname == "attention_fwd"
                            else [torch.empty_like(q)] if fname == "attention_dq"
                            else [torch.empty_like(q), torch.empty_like(q)])
                    f = getattr(lib, fname)
                    f.restype = ctypes.c_int
                    args = (*(_P(t.data_ptr()) for t in (*ins, *outs)), *tail)

                    def launch(f=f, args=args, name=name):
                        if f(*args) != 0:
                            raise RuntimeError(f"{fname} of the {name!r} copy failed")
                    launch()
                    first = [t.clone() for t in outs]
                    launch()
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(first, outs))
                    errs[name] = (", ".join(
                        f"{((a.double() - w).abs().max() / w.abs().max()).item():.3e}"
                        for a, w in zip(outs, want)) + f"; same bits twice {same}")
                    launches[name] = launch

                def both():
                    for fn in launches.values():
                        fn()

                dev = {name: profiler_ms(both, keys(i, name)[fname], bound_ms=bound_ms,
                                         sessions=3)
                       for i, name in enumerate(libs)}
                lib_ms = profiler_ms(library[fname], sessions=3)
                print(f"[control] {card}: {fname} {(BH, N, d)} f32, bound {bound_ms:.5f} ms "
                      f"({passes} TF32 passes): "
                      + "; ".join(f"{name} ({keys(i, name)[fname][:-1]}) profiler device time "
                                  f"{dev[name]} ms, events {cuda_ms(launches[name]):.4f} ms, "
                                  f"rel-to-max from the exact result {errs[name]}"
                                  for i, name in enumerate(libs))
                      + f"; SDPA {'forward' if fname == 'attention_fwd' else 'backward'} "
                      f"{lib_ms} ms", flush=True)
            del q, k, v, do, o, l, delta, q4, k4, v4, o4
    return 0


if __name__ == "__main__":
    sys.exit(main())
