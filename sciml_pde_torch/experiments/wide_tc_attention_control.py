"""The attention forward, dQ and dK/dV above head dim 1024: two groups of
128 output columns a block against one, dQ's K/V tiles of 64 keys against
32, and the cluster bodies at 1024 beside them, on the card.

    python -m sciml_pde_torch.experiments.wide_tc_attention_control

Above ``CLUSTER_MAX_D`` (1024) ``attention_fwd``, ``attention_dq`` and
``attention_dkv`` run ``fwd_wide_tc_kernel``, ``dq_wide_tc_kernel`` and
``dkv_wide_tc_kernel`` (``ops/csrc/attention.cu``): one block per (bh, 64
rows, ``WT_G`` groups of 128 output columns) that forms the scores of its
rows over all of d on the tensor cores.  Each of the ceil(d / (128 WT_G))
blocks of a row tile forms the same scores, so two groups a block (8
warps) halve that recomputation, and halve the blocks.  This builds the
shipped source, a copy with the other ``WT_G`` (all three bodies) and a
copy with dQ's other K/V tile (``WDQ_TC_TK``: 32 or 64 keys) (``variants``;
each copy's kernels renamed, ``_kernel`` to ``_v1_kernel`` and
``_v2_kernel``, so that a profiler session tells them apart), prints the
copies' registers and spills, and at (2, 256, 1032) and (4, 1280, 1032)
(the second fills the card), in f32 and bf16, checks each copy's outputs
against the exact result (the plain arithmetic in f64: largest error over
the largest magnitude, and whether a second launch gives the same bits)
and times them in the same profiler sessions (``profiler_ms``: the
median of three sessions in which the copies' launches take turns) beside
the SDPA forward or backward.  The cliff: the cluster bodies
(``fwd_wide_kernel``, ``dq_wide_kernel``, ``dkv_wide_kernel``) at head
dim 1024 at the same (bh, n), through the shipped source's kernels, each
time also over d (ms per column of d) beside the new body's.  Needs the card and nvcc; prints the card's name and power
limit and one line per reading.
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

SHAPES = ((2, 256, 1032), (4, 1280, 1032))
CLIFF_D = 1024
# the shipped source's groups of 128 output columns a block and dQ's keys a
# K/V tile (one line each)
GROUPS = re.compile(r"constexpr int WT_G = (\d);")
DQ_TILE = re.compile(r"constexpr int WDQ_TC_TK = (\d+);")
FNAMES = ("attention_fwd", "attention_dq", "attention_dkv")
BODIES = {"attention_fwd": "fwd_wide_tc", "attention_dq": "dq_wide_tc",
          "attention_dkv": "dkv_wide_tc"}
CLUSTER = {"attention_fwd": "fwd_wide", "attention_dq": "dq_wide", "attention_dkv": "dkv_wide"}
# H100 SXM data-sheet rates: the bound, the function's own products (bf16:
# 3, 4 and 6 products; f32: 6, 9 and 12 TF32 passes) or its bytes, the larger
PEAK = {torch.bfloat16: 989e12, torch.float32: 495e12}
PRODUCTS = {torch.bfloat16: {"attention_fwd": 3, "attention_dq": 4, "attention_dkv": 6},
            torch.float32: {"attention_fwd": 6, "attention_dq": 9, "attention_dkv": 12}}
HBM_BPS = 3.35e12
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def suffix(i: int) -> str:
    """The kernel-name suffix of copy i (0: the shipped source)."""
    return "_kernel" if i == 0 else f"_v{i}_kernel"


def designs(src: str) -> dict[str, tuple[int, int]]:
    """{copy name: (its WT_G, its WDQ_TC_TK)}: the shipped source's, then the
    other of 1 and 2 groups, then dQ's other of 32 and 64 keys."""
    groups, tiles = GROUPS.findall(src), DQ_TILE.findall(src)
    if len(groups) != 1 or groups[0] not in "12" or tiles not in (["32"], ["64"]):
        raise ValueError("expected one 'constexpr int WT_G = 1;' or '= 2;' and one "
                         "'constexpr int WDQ_TC_TK = 32;' or '= 64;' in attention.cu")
    g, tk = int(groups[0]), int(tiles[0])
    name = lambda g, tk: (f"{g} column group{'s' if g > 1 else ''} a block, "  # noqa: E731
                          f"dQ tiles of {tk} keys")
    return {name(g, tk): (g, tk), name(3 - g, tk): (3 - g, tk), name(g, 96 - tk): (g, 96 - tk)}


def variants(src: str) -> dict[str, str]:
    """The shipped source and the copies with the other WT_G and with dQ's
    other K/V tile, their kernels renamed."""
    out = {}
    for i, (name, (groups, tk)) in enumerate(designs(src).items()):
        text = GROUPS.sub(f"constexpr int WT_G = {groups};", src)
        text = DQ_TILE.sub(f"constexpr int WDQ_TC_TK = {tk};", text)
        out[name] = text.replace("_kernel", suffix(i)) if i else text
    return out


def keys(i: int) -> dict[str, str]:
    """The profiler keys of copy i's forward, dQ and dK/dV above 1024."""
    return {f: f"{BODIES[f]}{suffix(i)}<" for f in FNAMES}


def bound_ms(fname: str, bh: int, n: int, d: int, dt) -> float:
    """The least time of the function on the card: its products at the
    type's peak or its bytes (inputs read once, outputs written once)."""
    es = 2 if dt == torch.bfloat16 else 4
    panel, row = bh * n * d * es, bh * n * 4
    nbytes = {"attention_fwd": 4 * panel + row, "attention_dq": 5 * panel + 2 * row,
              "attention_dkv": 6 * panel + 2 * row}[fname]
    ops_s = PRODUCTS[dt][fname] * 2 * bh * n * n * d / PEAK[dt]
    return max(nbytes / HBM_BPS, ops_s) * 1e3


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


def _inputs(g, bh: int, n: int, d: int, dt):
    q, k, v, do = (torch.randn(bh, n, d, generator=g).to("cuda", dt) for _ in range(4))
    scale = d**-0.5
    o, l = ta.attention_fwd_plain(q, k, v, scale)
    delta = torch.sum(do.float() * o.float(), -1, keepdim=True)
    return q, k, v, do, l, delta, scale


def _launcher(lib, fname: str, ins, outs, tail, what: str):
    f = getattr(lib, fname)
    f.restype = ctypes.c_int
    args = (*(_P(t.data_ptr()) for t in (*ins, *outs)), *tail)

    def launch():
        if f(*args) != 0:
            raise RuntimeError(f"{fname} of {what} failed")
    return launch


def _outs(fname: str, q, l):
    return {"attention_fwd": [torch.empty_like(q), torch.empty_like(l)],
            "attention_dq": [torch.empty_like(q)],
            "attention_dkv": [torch.empty_like(q), torch.empty_like(q)]}[fname]


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
        names = list(libs)
        for i, (name, lib) in enumerate(libs.items()):
            for kern, regs, st, ld, frame in _build.copy_ptxas(lib):
                if any(kern.startswith(key[:-1] + "<") for key in keys(i).values()):
                    print(f"[control] {name}: {kern}: {regs} registers, {st} bytes spill "
                          f"stores, {ld} bytes spill loads, {frame} bytes stack frame",
                          flush=True)
        g = torch.Generator().manual_seed(3)
        for bh, n, d in SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                q, k, v, do, l, delta, scale = _inputs(g, bh, n, d, dt)
                tail = (_I(bh), _I(n), _I(d), _I(int(dt == torch.bfloat16)), _F(scale), stream)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
                o4 = sdpa(q4, k4, v4, scale=scale)
                bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), do[None],  # noqa: E731
                                                  retain_graph=True)
                library = {"attention_fwd": lambda: sdpa(q[None], k[None], v[None], scale=scale),
                           "attention_dq": bwd, "attention_dkv": bwd}
                # the cliff: the cluster bodies at head dim 1024, same (bh, n) and type
                c_in = _inputs(g, bh, n, CLIFF_D, dt)
                c_tail = (_I(bh), _I(n), _I(CLIFF_D), _I(int(dt == torch.bfloat16)),
                          _F(c_in[-1]), stream)
                for fname in FNAMES:
                    ins = (q, k, v) if fname == "attention_fwd" else (q, k, v, do, l, delta)
                    want = exact(fname, q, k, v, do, l, delta, scale)
                    launches, errs = {}, {}
                    for name, lib in libs.items():
                        outs = _outs(fname, q, l)
                        launch = _launcher(lib, fname, ins, outs, tail, f"the {name!r} copy")
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

                    b_ms = bound_ms(fname, bh, n, d, dt)
                    dev = {name: profiler_ms(both, keys(i)[fname], bound_ms=b_ms, sessions=3)
                           for i, name in enumerate(names)}
                    lib_ms = profiler_ms(library[fname], sessions=3)
                    c_ins = c_in[:3] if fname == "attention_fwd" else c_in[:6]
                    c_launch = _launcher(libs[names[0]], fname, c_ins,
                                         _outs(fname, c_in[0], c_in[4]), c_tail,
                                         "the cluster body at 1024")
                    c_key = f"{CLUSTER[fname]}_kernel<"
                    c_ms = profiler_ms(c_launch, c_key,
                                       bound_ms=bound_ms(fname, bh, n, CLIFF_D, dt), sessions=3)
                    per_col = lambda ms, dd: "not measured" if ms is None else f"{ms / dd:.3e}"  # noqa: E731
                    print(f"[control] {card}: {fname} {(bh, n, d)} {str(dt)[6:]}, bound "
                          f"{b_ms:.5f} ms: "
                          + "; ".join(f"{name} ({keys(i)[fname][:-1]}) profiler device time "
                                      f"{dev[name]} ms ({per_col(dev[name], d)} ms a column), "
                                      f"events {cuda_ms(launches[name]):.4f} ms, rel-to-max "
                                      f"from the exact result {errs[name]}"
                                      for i, name in enumerate(names))
                          + f"; SDPA {'forward' if fname == 'attention_fwd' else 'backward'} "
                          f"{lib_ms} ms; the cluster body at head dim {CLIFF_D} "
                          f"({c_key[:-1]}) {c_ms} ms ({per_col(c_ms, CLIFF_D)} ms a column)",
                          flush=True)
                del q, k, v, do, l, delta, q4, k4, v4, o4, c_in
    return 0


if __name__ == "__main__":
    sys.exit(main())
