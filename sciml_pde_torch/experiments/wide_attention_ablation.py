"""Timing ablation of the attention cluster bodies on the card.

    python -m sciml_pde_torch.experiments.wide_attention_ablation

``fwd_wide_kernel``, ``dq_wide_kernel`` and ``dkv_wide_kernel``
(``ops/csrc/attention.cu``, head dims 264-1024) add their ranks' partial
scores through distributed shared memory (``cluster_exchange``) between
cluster barriers.  This builds copies of the source with parts removed
(``variants``: the exchanges; the exchanges and the barriers), whose results
are wrong, and times the forward, dQ and dK/dV of each copy beside the
shipped source in CUDA events, in turns (the variants, then in reverse
order), at (4, 1280, 512) and (2, 1280, 1024) in bf16 and f32.  The
differences are what the exchange and the barriers cost.  Needs the card
and nvcc; prints the card's name and power limit and one line per timing.
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
from sciml_pde_torch.utils.profiling import cuda_ms

SHAPES = ((4, 1280, 512), (2, 1280, 1024))
# the exchange calls of the forward, of dQ and of dK/dV (the last two up to
# the end of their lambdas), each with the end of its statement, and the two
# halves of the cluster barrier
FWD_EXCHANGE = "cluster_exchange<1, LX, NT_TC, BF ? 4 : CL_MAX>("
DQ_EXCHANGE = "cluster_exchange<2, LX, NT_WKV, CL_MAX, 1>("
DKV_EXCHANGE = "cluster_exchange<2, LX, NT_WKV, CL_MAX>("
EXCHANGES = {FWD_EXCHANGE: ");", DQ_EXCHANGE: "});", DKV_EXCHANGE: "});"}
BARRIERS = ('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");',
            'asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");')


def _cut_call(src: str, head: str, end: str) -> str:
    """src without the one statement that starts with ``head`` and ends at
    the first ``end`` after it."""
    if src.count(head) != 1:
        raise ValueError(f"expected one {head!r} in attention.cu")
    i = src.index(head)
    return src[:i] + src[src.index(end, i) + len(end):]


def variants(src: str) -> dict[str, str]:
    """The shipped source and the copies with parts removed."""
    no_exchange = src
    for head, end in EXCHANGES.items():
        no_exchange = _cut_call(no_exchange, head, end)
    no_barriers = no_exchange
    for b in BARRIERS:
        if b not in src:
            raise ValueError(f"expected {b!r} in attention.cu")
        no_barriers = no_barriers.replace(b, "")
    return {"shipped": src, "no exchange": no_exchange,
            "no exchange, no barriers": no_barriers}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation times kernels on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "attention.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.build_copies(variants(src), Path(tmp))
        print(f"[ablation] {card}: built {', '.join(libs)}", flush=True)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        g = torch.Generator().manual_seed(3)
        stream = torch.cuda.current_stream().cuda_stream
        for bh, n, d in SHAPES:
            for dt in (torch.bfloat16, torch.float32):
                q, k, v, do = (torch.randn(bh, n, d, generator=g).to("cuda", dt) for _ in range(4))
                scale = d**-0.5
                o, l = ta.attention_fwd_plain(q, k, v, scale)
                delta = torch.sum(do.float() * o.float(), -1, keepdim=True)
                out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
                lo = torch.empty_like(l)
                bf = int(dt == torch.bfloat16)
                calls = {"forward": ("attention_fwd", (q, k, v, out, lo)),
                         "dQ": ("attention_dq", (q, k, v, do, l, delta, dq)),
                         "dK/dV": ("attention_dkv", (q, k, v, do, l, delta, dk, dv))}
                for name in (*libs, *reversed(libs)):
                    for what, (fname, ts) in calls.items():
                        f = getattr(libs[name], fname)
                        f.restype = ctypes.c_int
                        args = (*(P(t.data_ptr()) for t in ts), I(bh), I(n), I(d), I(bf),
                                F(scale), P(stream))
                        def launch():
                            if f(*args) != 0:
                                raise RuntimeError(f"{fname} of the {name!r} copy failed")
                        ms = cuda_ms(launch, reps=30)
                        print(f"[ablation] {card}: {what} {(bh, n, d)} {str(dt)[6:]} "
                              f"{name}: {ms:.4f} ms", flush=True)
                del q, k, v, do, o, l, delta, out, dq, dk, dv, lo
    return 0


if __name__ == "__main__":
    sys.exit(main())
