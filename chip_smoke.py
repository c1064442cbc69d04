#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``sciml_pde_torch/ops/csrc`` and drives the port's three main paths through
their entry points: the fused FNO-2D diffusion-reaction baseline step (batch
4, 128x128, 2 channels, initial_step 10, width 20, modes 12), the NS-2D
VideoMAE transformer baseline at full width (img 256, patch 16, tubelet 2,
3 channels, 10 frames -> 1280 tokens; encoder 768 x 12 with 12 heads,
decoder 512 x 8 with 8 heads, head dim 64; batch 2 x accumulation 4, bf16),
the production FNO-2D step at the DR flagship width (the plain model
through the dft2 spectral conv, adaptive clip, torch-style Adam) with the
fused dft2 layer op and the native-kernel probe, and the ported perf probe
(``sciml_pde_torch/experiments/perf_probe.py``: the K-step scans of both
FNO steps and the five split kernels):

  0. probe    build the probe kernel alone and launch it through the
              experiment's probe_native: native, and exactly 2 * x
  1. card     name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc for sm_90a, all sources in parallel; registers and
              spills of every attention kernel (ptxas -v), none spilling
              at head dim 64 on the tensor cores
  3. check    the fused forward and all ten gradients from the kernels
              against the plain PyTorch versions on the card, under
              `highest` (f32) and `default` (bf16 dot inputs); then every
              kernel against its own plain version on the inputs the main
              path gives it, and fno_stats at three more shapes (X*Y not a
              multiple of 4, a pair larger than one cluster's shared
              memory, the flagship + 1e3 with a one-pass control)
  4. train    one epoch of the DR baseline on a seeded in-memory store
              (10 trajectories x 101 frames x 128 x 128 x 2): finite and
              falling loss, launch counts of every kernel
  5. timing   fused step steps/s and per-launch kernel times (CUDA events;
              fno_stats also in profiler device time)
  6. attention the three flash-attention kernels against their plain
              versions (and the same bits from a second launch) at the
              encoder (24, 1280, 64) and decoder
              (16, 1280, 64) shapes and at head dims 96, 24, 160, 192 and
              256, in f32 and bf16, and at batch*heads 70000 (70000, 16,
              16) in bf16, with a control against a kernel that rounds p
              and ds to bf16
  7. model    one micro-step of the full-width VideoMAEOperator (loss and
              every gradient) through the kernels against the same model
              through the plain versions, with the bf16-vs-f32 gap as a
              control
  8. train    30 optimizer steps (3 epochs x 40 micro-steps) of the NS
              baseline on a seeded in-memory store (4 trajectories x 30
              frames x 256 x 256 x 3): finite and falling loss, best-val
              checkpoint, 20 launches of each attention kernel per
              micro-step
  9. timing   ms per micro-step and per optimizer step (CUDA events), the
              device-busy share and top device ops (torch.profiler), and
              per-launch attention kernel times (CUDA events and profiler
              device time) beside their bounds and the SDPA forward and
              backward, in bf16 and (the CUDA-core bodies) in f32
 10. layer    the fused dft2 layer (kernel) at (4, 130, 130, 20), modes 12,
              through its autograd op: against its plain f32 version within
              1e-5 of the largest magnitude, with the plain version on
              bf16-rounded inputs more than 10x that away as the control,
              and the gradients of sum(out^2) against autograd of the plain
              forward within 1e-5
 11. step     the plain FNO2d forward on the card under `highest` against
              the CPU in f32 within 1e-5 (the TF32 guard); 10 production
              steps against 10 fused steps from the same tree and batches
              (loss and grad norm rtol 2e-3, params rtol 5e-3 atol 1e-5,
              the JAX package's drop-in bounds)
 12. train    one DR epoch of the production step (cosine, `default`):
              finite and falling loss and a best-val checkpoint; a short
              StepLR run; a short autoregressive run whose windows run past
              the end of their trajectories (the gather clamps)
 13. timing   production steps/s (CUDA events), device-busy share and top
              device ops (torch.profiler), the dft vs dft2 A/B through the
              experiment's bench_shape, and per-launch times of the fused
              layer and the probe beside their bounds

 14. split    the five split functions (B1a-B2c) at the flagship shape under
              `highest` and `default`: each through the kernels against
              its plain version on the same inputs (phase 3's bounds), the
              stage-kernel launches of one call, a control under `default`
              (bf16 mix weights in `_bb_backward`, a bf16 spectrum in
              `_bb_weight_grads`, each further from the plain version than
              the kernels), the five chained against the plain fused VJP
              within 1e-4 (`highest`), and per-call times beside bounds
 15. probe    the ported perf probe, all eleven configs in this process
              (PROBE_SCAN_K 50) and one more through its subprocess runner:
              no error, finite results, the steps/s table, and launches of
              every split function and stage kernel

It prints the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero and
prints no result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# flagship DR shape (configs/config_dr.yaml, the JAX package's bench.py)
B, T0, CC, XY, WIDTH, MODES, PAD, NH = 4, 10, 2, 128, 20, 12, 2, 128
FNO_LAYERS = 4
N_TRAJ, N_T = 10, 101
# kernels vs plain versions, error bound relative to the largest magnitude
# of the plain result: f32 sums in another order (highest); bf16 dot inputs
# whose rounding a different summation order can flip (default).  The
# default bound lies below the gap between bf16 and f32 inputs, which the
# run measures and checks, so a kernel that ignores its precision fails.
TOL = {"highest": 1e-4, "default": 2e-3}
TOL_KERNEL = 1e-3  # one kernel against its plain version, main-path inputs
# fno_stats beyond the flagship: (what, win shape, offset added to N(0, 1))
STATS_SHAPES = (("X*Y not a multiple of 4", (3, 1, 3, 17, 13), 0.0),
                ("larger than one cluster's shared memory", (1, 10, 1, 256, 256), 0.0),
                ("flagship + 1e3", (B, T0, CC, XY, XY), 1e3))
# gradients against autograd of the independent plain forward in f32 (the
# exact gradient): under `default` the bound covers the bf16-vs-f32 gap
# (up to 9.2e-3 of the largest magnitude on an H100)
TOL_AUTOGRAD = {"highest": 1e-4, "default": 2e-2}
# H100 SXM data-sheet peaks: HBM bytes/s, and FLOP/s for the products'
# input type (f32 outside the tensor cores; bf16 dense)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"highest": 67e12, "default": 989e12}
# NS-2D VideoMAE recipe (reference config_transformer_aux_ns.yaml, the JAX
# package's experiments/ns_transformer.py and run_transformer_training)
NS_MODEL = dict(img_size=256, patch_size=16, tubelet_size=2, in_chans=3, num_frames=10,
                encoder_dim=768, encoder_depth=12, encoder_heads=12, decoder_dim=512,
                decoder_depth=8, decoder_heads=8)
NS_BATCH, NS_ACCUM, NS_LR, NS_EPOCHS = 2, 4, 1e-3, 3
NS_TRAJ, NS_T, NS_TEST = 4, 30, 2
NS_LAYERS = NS_MODEL["encoder_depth"] + NS_MODEL["decoder_depth"]
ATT_SHAPES = {"encoder": (NS_BATCH * 12, 1280, 64), "decoder": (NS_BATCH * 8, 1280, 64)}
# shapes the JAX package's kernels take beyond the NS recipe: head dims
# padded in shared memory (96 is plume-3D's decoder, 768 / 8 heads; 24 pads
# to 32), head dims above 128 (32-row f32 dQ and dK/dV tiles; two bf16
# blocks per row tile, each for half of the output columns), in both dtypes,
# and batch*heads above the 65535 of a grid's y axis
ATT_EXTRA = {"head dim 96": ((16, 1280, 96), ("float32", "bfloat16")),
             "head dim 24": ((16, 1280, 24), ("float32", "bfloat16")),
             "head dim 160": ((8, 1280, 160), ("float32", "bfloat16")),
             "head dim 192": ((8, 1280, 192), ("float32", "bfloat16")),
             "head dim 256": ((8, 1280, 256), ("float32", "bfloat16")),
             "batch*heads 70000": ((70_000, 16, 16), ("bfloat16",))}
# profiler keys of the attention kernels (their demangled names): the bf16
# tensor-core bodies and the f32 CUDA-core bodies
ATT_KERNEL_KEYS = {"bf16": {"attention_fwd": "fwd_tc_kernel<", "attention_dq": "dq_tc_kernel<",
                            "attention_dkv": "dkv_tc_kernel<"},
                   "f32": {"attention_fwd": "fwd_kernel<", "attention_dq": "dq_kernel<",
                           "attention_dkv": "dkv_kernel<"}}
# attention kernels vs plain versions: f32 outputs within 1e-5 of the
# largest magnitude (f32 sums in another order); bf16 outputs within one
# bf16 rounding step of the value (2^-7 of its magnitude: the two round
# f32 results that differ in the last f32 bits) plus the f32 bound
ATT_TOL_F32 = 1e-5
BF16_STEP = 2.0**-7
ATT_SITES = {"attention_fwd": "sciml_pde_tpu/ops/attention.py:52",
             "attention_dq": "sciml_pde_tpu/ops/attention.py:98",
             "attention_dkv": "sciml_pde_tpu/ops/attention.py:119"}
# the full-width model through the kernels vs through the plain versions,
# rel-to-max per output (loss and each gradient): f32 sums in another order
# through 20 layers; in bf16 a one-step rounding flip in one attention
# output moves every later bf16 rounding, so the two lie as far apart as
# bf16 noise (7.2e-3 measured on an H100; the bf16-vs-f32 gap is 1.0e-2)
TOL_MODEL = {"f32": 1e-4, "bf16": 2e-2}
FWD_SITE = "sciml_pde_tpu/ops/fno_fused_step.py:942"
BWD_SITE = "sciml_pde_tpu/ops/fno_fused_step.py:972"
KERNEL_SOURCE = {
    "fno_stats": "fwd", "fno_lift": "fwd", "fno_wdft": "fwd", "fno_wdft.adj": "fwd",
    "fno_corner": "fwd", "fno_corner.adj": "fwd", "fno_iwdft_pw": "fwd",
    "fno_iwdft_pw.adj": "fwd", "fno_head_fwd": "fwd", "fno_head_bwd": "bwd",
    "fno_mix_wgrad": "bwd", "fno_outer_partial": "bwd", "fno_reduce_rows": "bwd",
}
# fused dft2 layer (B6) against its plain f32 version and autograd of it:
# f32 sums in another order; the control (bf16-rounded inputs) must lie more
# than 10x the bound away, so a kernel that rounds or uses TF32 fails
SF_TOL = 1e-5
SF_SITE = "sciml_pde_tpu/ops/spectral_fused.py:63"
PROBE_SITE = "experiments/spectral_impl_bench.py:106"
# production step against the fused step over 10 steps under `highest`: the
# JAX package's drop-in bounds (tests/test_fast_step.py)
PROD_STEPS, PROD_RTOL, PARAM_RTOL, PARAM_ATOL = 10, 2e-3, 5e-3, 1e-5
TOL_FORWARD = 1e-5  # the plain FNO2d on the card vs the CPU in f32 (TF32 guard)
# the five split functions (B1a-B2c): each a sequence of the stage kernels
SPLIT_SITE = "sciml_pde_tpu/ops/fno_fused_step.py"
SPLIT_ROWS = {  # name: (TPU kernel body line, sources, packed params read)
    "bb_forward": (494, ("fwd",), ("wmr", "wmi", "pw", "pb", "w0t", "b0")),
    "head_forward": (542, ("fwd",), ("w1t", "b1", "w2t", "b2")),
    "head_backward": (559, ("bwd",), ("w1t", "b1", "w2t")),
    "bb_backward": (594, ("fwd", "bwd"), ("wmr", "wmi", "pw")),
    "bb_weight_grads": (636, ("fwd", "bwd"), ()),
}
SPLIT_STAGES = {  # stage-kernel launches of one call of each
    "bb_forward": {"fno_stats": 1, "fno_lift": 1, "fno_wdft": 4, "fno_corner": 4,
                   "fno_iwdft_pw": 4},
    "head_forward": {"fno_head_fwd": 1},
    "head_backward": {"fno_head_bwd": 1, "fno_reduce_rows": 1},
    "bb_backward": {"fno_lift": 1, "fno_wdft.adj": 4, "fno_corner.adj": 4,
                    "fno_iwdft_pw.adj": 4, "fno_outer_partial": 1, "fno_reduce_rows": 1},
    "bb_weight_grads": {"fno_wdft": 8, "fno_corner": 4, "fno_corner.adj": 4,
                        "fno_mix_wgrad": 4, "fno_outer_partial": 4, "fno_reduce_rows": 4},
}
TOL_SPLIT_CHAIN = 1e-4  # the five chained vs the plain fused VJP, `highest`
PROBE_SCAN_K = 50  # steps per scan in the probe phase (the probe's own default is 200)

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over the largest magnitude of ``want``)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def profiler_ms(fn, kernel_key: str = "", reps: int = 20):
    """Device time per call of ``fn`` in kernels whose name holds
    ``kernel_key`` (all of its device time by default), from torch.profiler
    over ``reps`` back-to-back calls (no host issue gaps); None when two
    profiler sessions in a row recorded no device time (the first session
    after another one has come back empty on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type.name == "CUDA" and kernel_key in ev.key)
        if us > 0:
            return us / reps / 1e3
    return None


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_profile(card: str, run, n: int, unit: str, unprofiled_ms: float, ours) -> None:
    """Run ``run()`` (``n`` units of work) under torch.profiler and print the
    wall time, the device-busy share (kernel time on the card over wall
    time), the share of it in kernels whose name holds one of ``ours``, and
    the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
    busy_us = sum(ev.self_device_time_total for ev in evs)
    if busy_us == 0:
        print("[profile] the profiler recorded no device time: not measured", flush=True)
        return
    mine = sum(ev.self_device_time_total for ev in evs if any(k in ev.key for k in ours))
    print(f"[profile] {card}: {n} {unit}s, wall {wall_us / n:.1f} us/{unit} (profiler on), "
          f"device busy {busy_us / n:.1f} us/{unit} = {100 * busy_us / wall_us:.1f}% (idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%), of it the port's kernels "
          f"{100 * mine / busy_us:.1f}%; device busy over the unprofiled {unit} "
          f"{unprofiled_ms * 1e3:.1f} us = {100 * busy_us / n / (unprofiled_ms * 1e3):.1f}%",
          flush=True)
    for ev in sorted(evs, key=lambda ev: -ev.self_device_time_total)[:12]:
        print(f"[profile]   {ev.self_device_time_total / n:9.1f} us/{unit} "
              f"{ev.count / n:6.1f}x  {ev.key[:90]}", flush=True)


def check_stats(dev) -> None:
    """Phase 3: ``fno_stats`` against its plain version beyond the flagship
    shape: X*Y not a multiple of 4 (misaligned runs), a pair larger than
    one cluster's shared memory, and the flagship with a +1e3 offset, where
    a one-pass E[x^2] - E[x]^2 (the control) must lie outside the bound
    that the kernel meets."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(10)
    for what, shape, off in STATS_SHAPES:
        win = (torch.randn(*shape, generator=g) + off).to(dev)
        got, want = fk.stats(win), fk.stats_plain(win)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        worst_rel = max(r for _, r in errs)
        msg = (f"[kernel] fno_stats {what} {shape}: max abs err {max(e for e, _ in errs):.3e}, "
               f"rel-to-max {worst_rel:.3e} (tol {TOL_KERNEL:.0e})")
        ok = all(bool(torch.isfinite(t).all()) for t in got) and worst_rel <= TOL_KERNEL
        if off:
            n = shape[1] * shape[3] * shape[4]
            mean = win.mean(dim=(1, 3, 4))
            var1 = ((win * win).mean(dim=(1, 3, 4)) - mean * mean) * (n / (n - 1))
            ctl = rel_err(torch.sqrt(var1.clamp_min(0)) + 1e-7, want[1])[1]
            ok &= ctl > TOL_KERNEL
            msg += f"; control: one-pass std {ctl:.3e} from the plain version, above the tol"
        check(ok, msg)


def make_store(seed: int = 0):
    """Smooth DR-shaped trajectories (N, T, X, Y, C): decaying superposed
    sinusoids with seeded amplitudes, wave numbers, phases and rates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, XY, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    t = np.linspace(0, 5, N_T, dtype=np.float32)
    data = np.empty((N_TRAJ, N_T, XY, XY, CC), np.float32)
    for n in range(N_TRAJ):
        for c in range(CC):
            field = np.zeros((N_T, XY, XY), np.float32)
            for _ in range(4):
                a, kx, ky = rng.normal(), rng.integers(1, 5), rng.integers(1, 5)
                px, py, lam = rng.uniform(0, 2 * np.pi, 2).tolist() + [rng.uniform(0.1, 0.6)]
                mode = np.sin(np.pi * kx * gx + px) * np.cos(np.pi * ky * gy + py)
                field += (a * np.exp(-lam * t))[:, None, None] * mode[None]
            data[n, ..., c] = field + 0.1 * rng.normal()
    return data, np.stack([gx, gy], axis=-1)


def make_ns_store(n_traj: int, n_t: int, seed: int, dev):
    """Smooth NS-shaped trajectories (N, T, 256, 256, 3) made on the card:
    per channel four travelling, decaying sinusoids with seeded amplitudes,
    wave numbers, phases, speeds and rates."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xy = NS_MODEL["img_size"]
    lin = torch.linspace(-1, 1, xy, device=dev)
    gx, gy = torch.meshgrid(lin, lin, indexing="ij")
    t = torch.linspace(0, 3, n_t, device=dev)[:, None, None]
    data = torch.zeros(n_traj, n_t, xy, xy, NS_MODEL["in_chans"], device=dev)
    for n in range(n_traj):
        for c in range(NS_MODEL["in_chans"]):
            for _ in range(4):
                a, kx, ky = rng.normal(), int(rng.integers(1, 5)), int(rng.integers(1, 5))
                px, py, cx, cy = rng.uniform(0, 2 * np.pi, 4).tolist()
                lam = rng.uniform(0.1, 0.5)
                data[n, ..., c] += (a * torch.exp(-lam * t)
                                    * torch.sin(np.pi * kx * gx + px + cx * t)
                                    * torch.cos(np.pi * ky * gy + py + cy * t))
            data[n, ..., c] += 0.1 * rng.normal()
    return data


def att_work(name: str, bh: int, n: int, d: int, bf: bool) -> tuple[int, float]:
    """(bytes each input read and each output written once, seconds of the
    products at the card's peak for their input type).  The bf16 kernels
    count the products their designs need to be exact to their bounds, all
    at the bf16 tensor-core rate (989 TFLOP/s), each f32 operand (p, ds) as
    two bf16 terms: the forward q.k^T and p.v (three products), dQ q.k^T,
    do.v^T and ds.k (four), dK/dV k.q^T, v.do^T, ds^T.q and p^T.do (six);
    at the encoder shape (24, 1280, 64) 0.01527, 0.02036 and 0.03054 ms.
    The f32 kernels take every product at the CUDA cores' 67 TFLOP/s: two,
    three and four products.  Before their tensor-core designs the bf16
    kernels' bounds counted the products that take p or ds at the f32 rate:
    0.08021 (forward), 0.08530 (dQ) and 0.16042 ms (dK/dV) at the encoder
    shape."""
    es = 2 if bf else 4
    panel, row = bh * n * d * es, bh * n * 4
    prod = 2 * bh * n * n * d
    rate = PEAK_FLOPS["default" if bf else "highest"]
    nbytes = {"attention_fwd": 3 * panel + panel + row,
              "attention_dq": 4 * panel + 2 * row + panel,
              "attention_dkv": 4 * panel + 2 * row + 2 * panel}[name]
    products = {"attention_fwd": (3, 2), "attention_dq": (4, 3), "attention_dkv": (6, 4)}[name]
    return nbytes, products[0 if bf else 1] * prod / rate


def att_bf16p(name: str, q, k, v, do=None, l=None, delta=None, scale: float = 1.0):
    """The plain version of one attention kernel with p and ds rounded to
    bf16 before their products, as ``jnp_attention`` rounds p: the
    control a kernel must lie nearer to its own plain version than."""
    import torch

    r = lambda t: t.bfloat16().float()  # noqa: E731
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if name == "attention_fwd":
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return (torch.matmul(r(e / e.sum(-1, keepdim=True)), v.float()).to(q.dtype),)
    p = torch.exp(s - l)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta)
    if name == "attention_dq":
        return ((torch.matmul(r(ds), k.float()) * scale).to(q.dtype),)
    return ((torch.matmul(r(ds).transpose(-1, -2), q.float()) * scale).to(q.dtype),
            torch.matmul(r(p).transpose(-1, -2), do.float()).to(q.dtype))


def check_attention(ta, dev) -> dict:
    """Phase 6: each kernel against its plain version (and a second launch
    of itself, which must give the same bits) at the encoder and decoder
    shapes and at the head dims of ATT_EXTRA in f32 and bf16, and at
    batch*heads 70000 in bf16.  Returns the bf16 encoder-shape inputs of
    each kernel (the main path's most frequent launch) for timing."""
    import torch

    g = torch.Generator().manual_seed(3)
    main_inputs = {}
    cases = [(where, shape, ("float32", "bfloat16")) for where, shape in ATT_SHAPES.items()]
    cases += [(where, shape, dts) for where, (shape, dts) in ATT_EXTRA.items()]
    for where, (bh, n, d), dts in cases:
        for dt in (getattr(torch, name) for name in dts):
            bf = dt == torch.bfloat16
            q, k, v, do = (torch.randn(bh, n, d, generator=g).to(dev, dt) for _ in range(4))
            scale = d**-0.5
            o_p, l_p = ta.attention_fwd_plain(q, k, v, scale)
            delta = torch.sum(do.float() * o_p.float(), dim=-1, keepdim=True)
            args = {"attention_fwd": (q, k, v),
                    "attention_dq": (q, k, v, do, l_p, delta),
                    "attention_dkv": (q, k, v, do, l_p, delta)}
            for name in ta.KERNEL_NAMES:
                got = as_tuple(getattr(ta, name)(*args[name], scale))
                again = as_tuple(getattr(ta, name)(*args[name], scale))
                want = as_tuple(getattr(ta, f"{name}_plain")(*args[name], scale))
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b) for a, b in zip(got, again))
                msgs = [f"same bits twice {ok}"]
                for i, (a, b) in enumerate(zip(got, want)):
                    err, rel = rel_err(a, b)
                    ok &= bool(torch.isfinite(a).all()) and a.dtype == b.dtype
                    if a.dtype == torch.float32:
                        ok &= rel <= ATT_TOL_F32
                        msgs.append(f"out{i} rel-to-max {rel:.3e} (tol {ATT_TOL_F32:.0e})")
                    else:
                        a32, b32 = a.float(), b.float()
                        lim = (BF16_STEP * torch.maximum(a32.abs(), b32.abs())
                               + ATT_TOL_F32 * b32.abs().max())
                        worst = ((a32 - b32).abs() / lim).max().item()
                        ok &= worst <= 1.0
                        msgs.append(f"out{i} rel-to-max {rel:.3e}, worst error over one bf16 "
                                    f"step {worst:.3f} (tol 1)")
                if bf:
                    # control: rounding p and ds to bf16 moves the outputs
                    # further (mean abs error) than the kernel lies from its
                    # plain version
                    ctl = att_bf16p(name, *args[name], scale=scale)
                    outs = [(a, b, c) for a, b, c in zip(got, want, ctl) if a.dtype == dt]
                    k_mean = max((a.float() - b.float()).abs().mean().item() for a, b, _ in outs)
                    c_mean = min((c.float() - b.float()).abs().mean().item() for _, b, c in outs)
                    ok &= k_mean < c_mean / 2
                    msgs.append(f"mean abs err {k_mean:.3e} vs bf16-p control {c_mean:.3e}")
                    if where == "encoder":
                        main_inputs[name] = (args[name], scale)
                check(ok, f"[attention] {name} {where} {tuple(q.shape)} {str(dt)[6:]}: "
                      + "; ".join(msgs))
            del q, k, v, do, o_p, l_p, delta, args
    return main_inputs


def check_model(dev, x, y) -> None:
    """Phase 7: one micro-step of the full-width VideoMAEOperator (loss and
    every gradient) through the kernels against the same weights through
    the plain versions, in f32 and in bf16.  The plain bf16-vs-f32 gap is
    the control: it must lie far above the f32 bound."""
    import torch
    from sciml_pde_torch.models.transformer import VideoMAEOperator
    from sciml_pde_torch.train.transformer_train import transformer_nrmse

    sd = None
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        for impl in ("flash", "plain"):
            model = VideoMAEOperator(**NS_MODEL, dtype=dt, attn_impl=impl,
                                     generator=torch.Generator().manual_seed(2))
            if sd is None:
                sd = model.state_dict()
            model.load_state_dict(sd)
            model.to(dev)
            names = [n for n, _ in model.named_parameters()]
            loss = transformer_nrmse(model(x), y)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            outs[str(dt)[6:], impl] = dict(zip(["loss"] + names, [loss.detach()] + list(grads)))
            del model, loss, grads
    torch.cuda.synchronize()

    def errs(a, b):
        return {n: rel_err(outs[a][n], outs[b][n])[1] for n in outs[b]}

    def worst(e):
        n = max(e, key=e.get)
        return f"{e[n]:.3e} ({n})"

    e32 = errs(("float32", "flash"), ("float32", "plain"))
    e16 = errs(("bfloat16", "flash"), ("bfloat16", "plain"))
    gap = errs(("bfloat16", "plain"), ("float32", "plain"))
    gap_k = errs(("bfloat16", "flash"), ("float32", "plain"))
    finite = all(bool(torch.isfinite(t).all()) for o in outs.values() for t in o.values())
    print(f"[model] loss f32 kernels {outs['float32', 'flash']['loss'].item():.6g}, plain "
          f"{outs['float32', 'plain']['loss'].item():.6g}; bf16 kernels "
          f"{outs['bfloat16', 'flash']['loss'].item():.6g}, plain "
          f"{outs['bfloat16', 'plain']['loss'].item():.6g}; {len(e32)} outputs", flush=True)
    check(finite and max(e32.values()) <= TOL_MODEL["f32"]
          and max(gap.values()) > 10 * TOL_MODEL["f32"],
          f"[model] f32 kernels vs plain, worst rel-to-max {worst(e32)} (tol "
          f"{TOL_MODEL['f32']:.0e}); control: plain bf16-vs-f32 gap {worst(gap)} above 10x the "
          f"tol")
    check(max(e16.values()) <= TOL_MODEL["bf16"]
          and max(gap_k.values()) <= 2 * max(gap.values()),
          f"[model] bf16 kernels vs plain, worst rel-to-max {worst(e16)} (tol "
          f"{TOL_MODEL['bf16']:.0e}); kernels vs f32 {worst(gap_k)}, at most twice the plain "
          f"version's {worst(gap)}")


def transformer_path(dev, card: str, run_dir: Path) -> dict:
    """Phases 6-9 (the NS VideoMAE path); returns the attention kernels'
    rows of the kernel table."""
    import torch

    from sciml_pde_torch.data.ns import NSBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.models.transformer import VideoMAEOperator
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.train.transformer_train import (
        build_transformer_baseline_step,
        make_transformer_optimizer,
        train_transformer_baseline,
    )

    rows = {}
    # ---- 6. attention kernels vs plain versions -------------------------------
    att_inputs = check_attention(ta, dev)

    # ---- 7. the full-width model through the kernels --------------------------
    store = make_ns_store(NS_TRAJ + NS_TEST, NS_T, seed=4, dev=dev)
    t_in = NS_MODEL["num_frames"]
    x = store[:NS_BATCH, :t_in]
    check_model(dev, x, store[:NS_BATCH, t_in])

    # ---- 8. train: the NS transformer baseline, through the trainer -----------
    ns_grid = torch.zeros(NS_MODEL["img_size"], NS_MODEL["img_size"], 2, device=dev)
    ns_ds = NSBaselineDataset(
        train=WindowedTrajectories(store[:NS_TRAJ], ns_grid, initial_step=t_in, rollout=1,
                                   train=True, device=dev),
        test=WindowedTrajectories(store[NS_TRAJ:, :t_in + 1], ns_grid, initial_step=t_in,
                                  rollout=1, train=False, device=dev),
    )
    micro = len(ns_ds.train.window_index()) // NS_BATCH * NS_EPOCHS
    val_batches = -(-NS_TEST // NS_BATCH) * NS_EPOCHS
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_transformer_baseline(
        ns_ds, img_size=NS_MODEL["img_size"], patch_size=NS_MODEL["patch_size"],
        tubelet_size=NS_MODEL["tubelet_size"], in_chans=NS_MODEL["in_chans"],
        encoder_embed_dim=NS_MODEL["encoder_dim"], encoder_depth=NS_MODEL["encoder_depth"],
        encoder_num_heads=NS_MODEL["encoder_heads"], decoder_embed_dim=NS_MODEL["decoder_dim"],
        decoder_depth=NS_MODEL["decoder_depth"], decoder_num_heads=NS_MODEL["decoder_heads"],
        drop_path_rate=0.1, bf16=True, initial_step=t_in, batch_size=NS_BATCH,
        grad_accum=NS_ACCUM, epochs=NS_EPOCHS, learning_rate_share=NS_LR,
        learning_rate_heads=NS_LR, seed=0, run_dir=str(run_dir),
        model_name="NS_smoke_VMAE", log_every=0, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    att_launches = dict(ta.LAUNCHES)
    hist = res.history
    print(f"[train] NS VideoMAE, {micro} micro-steps = {micro // NS_ACCUM} optimizer steps "
          f"(batch {NS_BATCH} x accumulation {NS_ACCUM}, lr {NS_LR} cosine, bf16) + "
          f"{val_batches} val batches in {train_s:.3f} s: first step loss "
          f"{hist[0]['first_step_loss']:.6g}; per epoch train loss "
          + ", ".join(f"{h['train_loss']:.6g}" for h in hist) + "; val loss "
          + ", ".join(f"{h['val_loss']:.6g}" for h in hist), flush=True)
    losses = [hist[0]["first_step_loss"]] + [h[k] for h in hist
                                             for k in ("train_loss", "val_loss", "last_step_loss")]
    check(all(math.isfinite(v) for v in losses), "[train] NS losses finite")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"] < hist[0]["first_step_loss"],
          "[train] NS loss falls (first epoch mean below the first step, last epoch mean "
          "below the first)")
    check((run_dir / "NS_smoke_VMAE_ckpt.pt").exists(), "[train] NS best-val checkpoint written")
    print(f"[train] launches: {json.dumps(att_launches)}", flush=True)
    want = {"attention_fwd": NS_LAYERS * (micro + val_batches),
            "attention_dq": NS_LAYERS * micro, "attention_dkv": NS_LAYERS * micro}
    for name in ta.KERNEL_NAMES:
        check(att_launches[name] == want[name] > 0,
              f"[train] main path launched {name} {att_launches[name]}x ({NS_LAYERS} per "
              f"micro-step{' and per val batch' if name == 'attention_fwd' else ''}: "
              f"{want[name]} expected)")

    # ---- 9. timing of the transformer path ------------------------------------
    model = VideoMAEOperator(**NS_MODEL, drop_path_rate=0.1, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0)).to(dev)
    params = dict(model.named_parameters())
    opt = make_transformer_optimizer(params, NS_LR, NS_LR, 1000, grad_accum=NS_ACCUM)
    step, _ = build_transformer_baseline_step(model, opt, t_in)
    idx_all = torch.as_tensor(ns_ds.train.window_index(), dtype=torch.long, device=dev)
    batches = [idx_all[i * NS_BATCH:(i + 1) * NS_BATCH] for i in range(2 * NS_ACCUM)]
    for b in batches[:NS_ACCUM]:
        step(ns_ds.train.data, b)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for b in batches:
        loss, _ = step(ns_ds.train.data, b)
    e.record()
    e.synchronize()
    micro_ms = s.elapsed_time(e) / len(batches)
    check(bool(torch.isfinite(loss)), "[timing] NS loss finite")
    print(f"[timing] {card}: NS VideoMAE micro-step {micro_ms:.4f} ms, optimizer step "
          f"{micro_ms * NS_ACCUM:.4f} ms ({NS_ACCUM} micro-steps, batch {NS_BATCH}, "
          f"1280 tokens, bf16)", flush=True)
    def one_optimizer_step():
        for b in batches[:NS_ACCUM]:
            step(ns_ds.train.data, b)
    device_profile(card, one_optimizer_step, NS_ACCUM, "micro-step", micro_ms,
                   tuple(key for keys in ATT_KERNEL_KEYS.values() for key in keys.values()))
    del model, opt, step, params

    sdpa = torch.nn.functional.scaled_dot_product_attention
    (q, k, v), scale = att_inputs["attention_fwd"]
    (_, _, _, do, _, _), _ = att_inputs["attention_dq"]
    bh, n, d = q.shape
    as4 = lambda t: t.view(NS_BATCH, bh // NS_BATCH, n, d)  # noqa: E731
    q4, k4, v4 = (as4(t).detach().requires_grad_(True) for t in (q, k, v))
    o4 = sdpa(q4, k4, v4, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), as4(do), retain_graph=True)  # noqa: E731
    lib = {"attention_fwd": cuda_ms(lambda: sdpa(as4(q), as4(k), as4(v), scale=scale))}
    lib["attention_dq"] = lib["attention_dkv"] = cuda_ms(sdpa_bwd)
    lib_dev = {"attention_fwd": profiler_ms(lambda: sdpa(as4(q), as4(k), as4(v), scale=scale))}
    lib_dev["attention_dq"] = lib_dev["attention_dkv"] = profiler_ms(sdpa_bwd)
    for name in ta.KERNEL_NAMES:
        args, scale = att_inputs[name]
        nbytes, ops_s = att_work(name, bh, n, d, bf=True)
        rows[name] = {
            "name": name, "route": "cuda", "source": "sciml_pde_torch/ops/csrc/attention.cu",
            "replaces": ATT_SITES[name], "launches": att_launches[name],
            "max_abs_err": max(rel_err(a, b)[0] for a, b in zip(
                as_tuple(getattr(ta, name)(*args, scale)),
                as_tuple(getattr(ta, f"{name}_plain")(*args, scale)))),
            "ms": cuda_ms(lambda: getattr(ta, name)(*args, scale)),
            "plain_ms": cuda_ms(lambda: getattr(ta, f"{name}_plain")(*args, scale)),
            "bound_ms": max(nbytes / HBM_BPS, ops_s) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BPS >= ops_s else "operations",
            "library_ms": lib[name],
            "device_ms": profiler_ms(lambda: getattr(ta, name)(*args, scale),
                                     ATT_KERNEL_KEYS["bf16"][name]),
            "library_device_ms": lib_dev[name],
        }
        r = rows[name]
        print(f"[timing] {card}: {name} at {tuple(q.shape)} bf16: {r['ms']:.4f} ms/launch "
              f"(profiler device time {fmt(r['device_ms'])}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"library {r['library_ms']:.4f} ms (scaled_dot_product_attention "
              f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV together'}"
              f"; profiler device time {fmt(r['library_device_ms'])}), "
              f"{r['launches']} launches in the training run", flush=True)
    for where, (bh_d, n_d, d_d) in ATT_SHAPES.items():
        if where == "encoder":
            continue
        g = torch.Generator().manual_seed(5)
        qd, kd, vd, dod = (torch.randn(bh_d, n_d, d_d, generator=g).to(dev, torch.bfloat16)
                           for _ in range(4))
        od, ld = ta.attention_fwd(qd, kd, vd, scale)
        deltad = torch.sum(dod.float() * od.float(), dim=-1, keepdim=True)
        print(f"[timing] {card}: {where} shape {(bh_d, n_d, d_d)} bf16: attention_fwd "
              f"{cuda_ms(lambda: ta.attention_fwd(qd, kd, vd, scale)):.4f} ms, attention_dq "
              f"{cuda_ms(lambda: ta.attention_dq(qd, kd, vd, dod, ld, deltad, scale)):.4f} ms, "
              f"attention_dkv "
              f"{cuda_ms(lambda: ta.attention_dkv(qd, kd, vd, dod, ld, deltad, scale)):.4f} ms",
              flush=True)
    # the f32 kernels keep the CUDA-core bodies: their times at the encoder
    # shape beside their plain versions and the f32 SDPA forward and backward
    # on the same inputs
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    q4f, k4f, v4f = (as4(t).detach().requires_grad_(True) for t in (qf, kf, vf))
    o4f = sdpa(q4f, k4f, v4f, scale=scale)
    of, lf = ta.attention_fwd(qf, kf, vf, scale)
    deltaf = torch.sum(dof * of, dim=-1, keepdim=True)
    f32_args = {"attention_fwd": (qf, kf, vf), "attention_dq": (qf, kf, vf, dof, lf, deltaf),
                "attention_dkv": (qf, kf, vf, dof, lf, deltaf)}
    sdpa_f32 = {"attention_fwd": lambda: sdpa(as4(qf), as4(kf), as4(vf), scale=scale)}
    sdpa_f32["attention_dq"] = sdpa_f32["attention_dkv"] = lambda: torch.autograd.grad(
        o4f, (q4f, k4f, v4f), as4(dof), retain_graph=True)
    for name in ta.KERNEL_NAMES:
        r, args = rows[name], f32_args[name]
        r["f32_ms"] = cuda_ms(lambda: getattr(ta, name)(*args, scale))
        r["f32_device_ms"] = profiler_ms(lambda: getattr(ta, name)(*args, scale),
                                         ATT_KERNEL_KEYS["f32"][name])
        r["f32_plain_ms"] = cuda_ms(lambda: getattr(ta, f"{name}_plain")(*args, scale))
        r["f32_library_ms"] = cuda_ms(sdpa_f32[name])
        r["f32_library_device_ms"] = profiler_ms(sdpa_f32[name])
        f32_bytes, f32_ops_s = att_work(name, bh, n, d, bf=False)
        r["f32_bound_ms"] = max(f32_bytes / HBM_BPS, f32_ops_s) * 1e3
        print(f"[timing] {card}: {name} at {tuple(q.shape)} f32 (CUDA-core body): "
              f"{r['f32_ms']:.4f} ms/launch (profiler device time {fmt(r['f32_device_ms'])}), "
              f"plain {r['f32_plain_ms']:.4f} ms, bound {r['f32_bound_ms']:.5f} ms "
              f"(operations), library {r['f32_library_ms']:.4f} ms "
              f"(scaled_dot_product_attention "
              f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV together'}"
              f", f32; profiler device time {fmt(r['f32_library_device_ms'])})", flush=True)

    return rows


def sf_work(x, w1, w2, pw, bias, out, m1: int, m2: int) -> tuple[int, int]:
    """(bytes each input read and each output written once, f32 FLOPs) of one
    fused dft2 layer: the W-axis rDFT, the corner DFT, the mode mix, the
    inverse corner DFT, the inverse W step and the pointwise product."""
    b, h, w, c = x.shape
    o, r, k = out.shape[-1], 2 * m1, m2
    nbytes = sum(t.numel() * 4 for t in (x, w1, w2, pw, bias, out))
    flops = 2 * b * (h * w * c * 2 * k + 2 * h * 2 * r * k * c + 2 * c * 2 * o * r * k
                     + 2 * r * 2 * h * k * o + h * w * o * 2 * k + h * w * c * o)
    return nbytes, flops


def check_layer(dev) -> tuple:
    """Phase 10: the fused dft2 layer through its autograd op at the flagship
    layer shape.  Returns its inputs and the launches of the run."""
    import torch
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf

    g = torch.Generator().manual_seed(6)
    hp = XY + PAD
    k = 1.0 / math.sqrt(WIDTH)
    x = torch.randn(B, hp, hp, WIDTH, generator=g).to(dev)
    w1, w2 = ((torch.rand(2, WIDTH, WIDTH, MODES, MODES, generator=g) / WIDTH**2).to(dev)
              for _ in range(2))
    pw = ((2 * torch.rand(WIDTH, WIDTH, generator=g) - 1) * k).to(dev)
    bias = ((2 * torch.rand(WIDTH, generator=g) - 1) * k).to(dev)
    spectral.set_dft_precision("highest")
    ins = [t.clone().requires_grad_(True) for t in (x, w1, w2, pw, bias)]
    sf.reset_launch_counts()
    out = sf.fused_fno_layer_2d(*ins, MODES, MODES)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    launches = sf.LAUNCHES["spectral_fused"]
    check(launches == 1, f"[layer] the op launched the fused layer kernel {launches}x (1 expected)")
    ref_in = [t.clone().requires_grad_(True) for t in (x, w1, w2, pw, bias)]
    ref = sf.fused_fno_layer_2d_plain(*ref_in, MODES, MODES)
    (ref * ref).sum().backward()
    r16 = lambda t: t.bfloat16().float()  # noqa: E731
    ctl = sf.fused_fno_layer_2d_plain(r16(x), r16(w1), r16(w2), r16(pw), r16(bias), MODES, MODES)
    torch.cuda.synchronize()
    err, rel = rel_err(out.detach(), ref.detach())
    ctl_rel = rel_err(ctl, ref.detach())[1]
    check(bool(torch.isfinite(out).all()) and rel <= SF_TOL and ctl_rel > 10 * SF_TOL,
          f"[layer] spectral_fused {tuple(x.shape)} modes {MODES}: max abs err {err:.3e}, "
          f"rel-to-max {rel:.3e} (tol {SF_TOL:.0e}); control: plain on bf16-rounded inputs "
          f"{ctl_rel:.3e} above 10x the tol")
    for name, a, b in zip(("dx", "dw1", "dw2", "dpw", "dbias"), ins, ref_in):
        gerr, grel = rel_err(a.grad, b.grad)
        check(grel <= SF_TOL, f"[layer] {name} of sum(out^2) vs autograd of the plain forward: "
              f"max abs err {gerr:.3e}, rel-to-max {grel:.3e} (tol {SF_TOL:.0e})")
    spectral.set_dft_precision("default")
    return (x, w1, w2, pw, bias), out.detach(), err, launches


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def production_path(dev, card: str, run_dir: Path, store, grid, tree, ds) -> dict:
    """Phases 10-13 (the production FNO step, the fused dft2 layer and the
    probe's timing); returns the layer's row of the kernel table."""
    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import DRBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories, gather_windows
    from sciml_pde_torch.experiments.spectral_impl_bench import bench_shape
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import build_baseline_step, train_baseline
    from sciml_pde_torch.train.optim import make_optimizer
    from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

    # ---- 10. the fused dft2 layer ---------------------------------------------
    layer_in, layer_out, layer_err, layer_launches = check_layer(dev)

    # ---- 11. the production step against the fused step ----------------------
    spectral.set_dft_precision("highest")
    model = FNO2d(CC, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    x = torch.from_numpy(store[:B, :T0]).permute(0, 2, 3, 1, 4).contiguous()
    gb = torch.from_numpy(grid)[None].expand(B, *grid.shape)
    with torch.no_grad():
        on_cpu = model(x, gb)
        on_card = model.to(dev)(x.to(dev), gb.to(dev)).cpu()
    err, rel = rel_err(on_card, on_cpu)
    check(rel <= TOL_FORWARD, f"[step] plain FNO2d forward ({spectral.get_spectral_impl()}, "
          f"highest) on the card vs the CPU in f32: max abs err {err:.3e}, rel-to-max "
          f"{rel:.3e} (tol {TOL_FORWARD:.0e})")
    data, gridd = ds.train.data, ds.train.grid
    rng = np.random.default_rng(7)
    widx = ds.train.window_index()
    idxs = [torch.as_tensor(widx[rng.choice(len(widx), B, replace=False)], dtype=torch.long,
                            device=dev) for _ in range(PROD_STEPS)]
    params = dict(model.named_parameters())
    step, _ = build_baseline_step(model, make_optimizer(params, 1e-3, 10_000), T0, 1)
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    fopt = fs.init_opt(theta)
    fstep, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
    grid2 = gridd.permute(2, 0, 1).contiguous()
    worst = {"loss": 0.0, "grad norm": 0.0}
    for idx in idxs:
        loss_p, gn_p = step(data, gridd, idx)
        theta, fopt, loss_f, gn_f = fstep(theta, fopt, data, grid2, idx)
        for key, a, b in (("loss", loss_f, loss_p), ("grad norm", gn_f, gn_p)):
            worst[key] = max(worst[key], abs(float(a) - float(b)) / abs(float(b)))
    got = flat_leaves(fs.tree_from_fast_state(theta, spec, MODES))
    want = flat_leaves(state_dict_to_flax(params))
    excess = max(((got[k].to(dev) - torch.as_tensor(v, device=dev)).abs()
                  - PARAM_RTOL * torch.as_tensor(v, device=dev).abs()).max().item()
                 for k, v in want.items())
    check(max(worst.values()) <= PROD_RTOL and excess <= PARAM_ATOL,
          f"[step] {PROD_STEPS} production steps vs fused steps (highest): worst rel loss "
          f"{worst['loss']:.3e}, grad norm {worst['grad norm']:.3e} (rtol {PROD_RTOL:.0e}); "
          f"params |a-b| - {PARAM_RTOL:.0e}|b| at most {excess:.3e} (atol {PARAM_ATOL:.0e})")
    del model, params, step, theta, fopt, fstep

    # ---- 12. train on the production step -------------------------------------
    spectral.set_dft_precision("default")
    t0 = time.perf_counter()
    res = train_baseline(ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, learning_rate=1e-3, seed=0,
                         run_dir=str(run_dir), model_name="DR_smoke_prod_FNO", log_every=0,
                         fast_step=False, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    h = res.history[0]
    n_steps = len(ds.train.window_index()) // B
    print(f"[train] production step ({spectral.get_spectral_impl()}, default, cosine), "
          f"{n_steps} steps + val in {train_s:.3f} s: first step loss {h['first_step_loss']:.6g}, "
          f"last step loss {h['last_step_loss']:.6g}, epoch train loss {h['train_loss']:.6g}, "
          f"val loss {h['val_loss']:.6g}", flush=True)
    check(all(math.isfinite(h[k]) for k in ("first_step_loss", "last_step_loss", "train_loss",
                                            "val_loss")), "[train] production losses finite")
    check(h["last_step_loss"] < h["first_step_loss"] and h["train_loss"] < h["first_step_loss"],
          "[train] production loss falls (last step and epoch mean below the first step)")
    check((run_dir / "DR_smoke_prod_FNO_ckpt.pt").exists(),
          "[train] production best-val checkpoint written")

    def small(n_t, rollout=1):
        return DRBaselineDataset(
            train=WindowedTrajectories(ds.train.data[:1, :n_t], grid, initial_step=T0,
                                       rollout=rollout, train=True, device=dev),
            test=WindowedTrajectories(ds.test.data[:, :n_t], grid, initial_step=T0,
                                      rollout=rollout, train=False, device=dev))
    res = train_baseline(small(30), modes=MODES, width=WIDTH, initial_step=T0,
                         num_channels=CC, batch_size=B, epochs=2, scheduler="step",
                         scheduler_step=3, scheduler_gamma=0.5, seed=0, run_dir=str(run_dir),
                         model_name="DR_smoke_steplr_FNO", log_every=0, fast_step=False,
                         device=dev)
    losses = [v for hh in res.history for v in (hh["train_loss"], hh["val_loss"])]
    print(f"[train] StepLR (step 3, gamma 0.5), 2 epochs x 5 steps: train/val losses "
          + ", ".join(f"{v:.6g}" for v in losses), flush=True)
    check(len(res.history) == 2 and all(map(math.isfinite, losses))
          and (run_dir / "DR_smoke_steplr_FNO_ckpt.pt").exists(),
          "[train] StepLR run: finite losses and a checkpoint")
    n_t, t_train = 40, T0 + 5
    ar = small(n_t)
    widx = ar.train.window_index()
    idx = torch.as_tensor(widx[-B:], dtype=torch.long, device=dev)
    _, y = gather_windows(ar.train.data, idx, T0, t_train - T0)
    frames = np.minimum(widx[-B:, 1, None] + T0 + np.arange(t_train - T0)[None], n_t - 1)
    want_y = np.moveaxis(ar.train.data.cpu().numpy()[widx[-B:, 0, None], frames], 1, -2)
    check(bool(torch.equal(y.cpu(), torch.from_numpy(want_y))),
          f"[train] the gather clamps frames past the end on the card (t0 up to "
          f"{int(widx[-1, 1])}, {t_train - T0} target frames of {n_t})")
    res = train_baseline(ar, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, training_type="autoregressive",
                         t_train=t_train, seed=0, run_dir=str(run_dir),
                         model_name="DR_smoke_ar_FNO", log_every=0, fast_step=False, device=dev)
    torch.cuda.synchronize()
    h = res.history[0]
    print(f"[train] autoregressive, t_train {t_train} ({t_train - T0} teacher-forced steps), "
          f"{len(widx) // B} steps: first step loss {h['first_step_loss']:.6g}, train loss "
          f"{h['train_loss']:.6g}, val loss {h['val_loss']:.6g}", flush=True)
    check(all(math.isfinite(h[k]) for k in ("first_step_loss", "train_loss", "val_loss")),
          "[train] autoregressive run finite, no device assert")

    # ---- 13. timing -------------------------------------------------------------
    model = FNO2d(CC, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    model.to(dev)
    params = dict(model.named_parameters())
    step, _ = build_baseline_step(model, make_optimizer(params, 1e-3, 10_000), T0, 1)
    idx = idxs[0]
    for _ in range(3):
        step(data, gridd, idx)
    torch.cuda.synchronize()
    n = 30
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        loss, _ = step(data, gridd, idx)
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / n
    check(bool(torch.isfinite(loss)), "[timing] production loss finite")
    print(f"[timing] {card}: production step ({spectral.get_spectral_impl()}, default) "
          f"{step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s (batch {B}, 128^2, width {WIDTH}, "
          f"modes {MODES})", flush=True)

    def prod_steps():
        for _ in range(10):
            step(data, gridd, idx)
    device_profile(card, prod_steps, 10, "step", step_ms, ())
    ab = bench_shape("dr", B, XY, CC, steps=30, windows=3, device=dev)
    print(f"[timing] {card}: bench_shape dr: dft {ab['dft']['steps_per_sec_median']:.2f} "
          f"steps/s, dft2 {ab['dft2']['steps_per_sec_median']:.2f} steps/s, dft2/dft "
          f"{ab['speedup_dft2_vs_dft']:.4f} (median of 3 windows of 30 steps)", flush=True)
    print(json.dumps({"bench_shape": ab}), flush=True)

    nbytes, flops = sf_work(*layer_in, layer_out, MODES, MODES)
    row = {
        "name": "spectral_fused", "route": "cuda",
        "source": "sciml_pde_torch/ops/csrc/spectral_fused.cu", "replaces": SF_SITE,
        "launches": layer_launches, "max_abs_err": layer_err,
        "ms": cuda_ms(lambda: sf.spectral_fused_layer(*layer_in, MODES, MODES)),
        "plain_ms": cuda_ms(lambda: sf.fused_fno_layer_2d_plain(*layer_in, MODES, MODES)),
        "bound_ms": max(nbytes / HBM_BPS, flops / PEAK_FLOPS["highest"]) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BPS >= flops / PEAK_FLOPS["highest"]
        else "operations",
        "library_ms": None,
    }
    print(f"[timing] {card}: spectral_fused at {tuple(layer_in[0].shape)} f32: "
          f"{row['ms']:.4f} ms/launch, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {nbytes} bytes, {flops} FLOP), "
          f"{row['launches']} launch in the layer run", flush=True)
    return {"spectral_fused": row}


def split_flops(name: str, b: int, t: int) -> int:
    """FLOPs one call of a split function needs at the flagship shape: the
    products of the JAX kernel's body, dot and mode mix, 2 per
    multiply-add (8 per complex one); sums and activations not counted."""
    c, k, r, hp, nx = WIDTH, MODES, 2 * MODES, XY + PAD, XY
    npix, field, f = b * nx * nx, b * hp * hp, t * CC + 2
    wdft, corner_dft = 2 * field * c * 2 * k, 8 * b * k * c * r * hp
    mix = 8 * b * k * r * c * c
    layer = wdft + 2 * corner_dft + mix + 2 * field * c * (2 * k + c)
    return {
        "bb_forward": 2 * npix * f * c + FNO_LAYERS * layer,
        "head_forward": 2 * npix * (NH * c + CC * NH),
        "head_backward": 2 * npix * (3 * NH * c + 2 * CC * NH),
        "bb_backward": FNO_LAYERS * layer + 2 * npix * c * f,
        "bb_weight_grads": FNO_LAYERS * (2 * wdft + 2 * corner_dft + mix + 2 * field * c * c),
    }[name]


def split_path(dev, card: str, win, grid2, p, cot) -> dict:
    """Phase 14: the five split functions at the flagship shape; returns
    their rows of the kernel table (launches filled in by phase 15)."""
    from types import SimpleNamespace

    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in tensors(y)] if isinstance(x, (tuple, list)) else []

    def worst(outs_a, outs_b):
        errs = [rel_err(a, b) for a, b in zip(tensors(outs_a), tensors(outs_b))]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def bf16_spectrum_corner(a, pf, w, q, adj, spec_dtype, bf, spec_only=False):
        return fk.corner_plain(a, pf, w, q, adj, spec_dtype if adj else torch.bfloat16, bf,
                               spec_only)

    ops_bf16_spec = SimpleNamespace(**{**vars(fk.PLAIN), "corner": bf16_spectrum_corner})
    rd = lambda t: t.bfloat16().float()  # noqa: E731
    p_bf16_mix = p._replace(wmr=rd(p.wmr), wmi=rd(p.wmi))
    rows, timing = {}, {}
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        # the chain through the kernels; each call's inputs kept for the checks
        pre, bbout, stats, h0p = ff._bb_forward(win, grid2, p, MODES, MODES, PAD)
        pred = ff._head_forward(bbout, stats, p)
        dbb, dw1t, db1, dw2t, db2 = ff._head_backward(cot, bbout, stats, p)
        dpre, dw0t, db0 = ff._bb_backward(dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)
        dwmr, dwmi, dpw, dpb = ff._bb_weight_grads(pre, h0p, dpre, p, MODES, MODES, PAD, XY, XY)
        calls = {
            "bb_forward": (ff._bb_forward, (win, grid2, p, MODES, MODES, PAD)),
            "head_forward": (ff._head_forward, (bbout, stats, p)),
            "head_backward": (ff._head_backward, (cot, bbout, stats, p)),
            "bb_backward": (ff._bb_backward, (dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)),
            "bb_weight_grads": (ff._bb_weight_grads, (pre, h0p, dpre, p, MODES, MODES, PAD, XY,
                                                      XY)),
        }
        for name, (fn, args) in calls.items():
            fk.reset_launch_counts()
            out_k = fn(*args)
            torch.cuda.synchronize()
            stages = {k: v for k, v in fk.LAUNCHES.items() if v}
            out_p = fn(*args, ops=fk.PLAIN)
            err, rel = worst(out_k, out_p)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(out_k))
            check(finite and rel <= TOL[prec] and stages == SPLIT_STAGES[name],
                  f"[split {prec}] {name}: max abs err {err:.3e}, rel-to-max {rel:.3e} (tol "
                  f"{TOL[prec]:.0e}); stage launches per call {json.dumps(stages)}")
            if prec == "default" and name in ("bb_backward", "bb_weight_grads"):
                if name == "bb_backward":
                    ctl = fn(*args[:5], p_bf16_mix, *args[6:], ops=fk.PLAIN)
                    what = "plain version with bf16-rounded mix weights"
                else:
                    ctl = fn(*args, ops=ops_bf16_spec)
                    what = "plain version with a bf16 spectrum"
                ctl_rel = worst(ctl, out_p)[1]
                check(rel < ctl_rel / 2, f"[split default] {name} control: the {what} lies "
                      f"{ctl_rel:.3e} from the plain version, the kernels {rel:.3e} (below half)")
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: fn(*args, ops=fk.PLAIN))
            timing[name, prec] = (ms, plain_ms)
            if prec == "highest":
                _, sources, fields = SPLIT_ROWS[name]
                nbytes = sum(t.numel() * t.element_size() for t in
                             tensors([a for a in args if not isinstance(a, ff.FastFNOParams)])
                             + [getattr(p, f) for f in fields] + tensors(out_k))
                fl = split_flops(name, B, T0)
                bound_s = max(nbytes / HBM_BPS, fl / PEAK_FLOPS[prec])
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": f"sciml_pde_torch/ops/csrc/fno_{sources[0]}.cu",
                    "sources": [f"sciml_pde_torch/ops/csrc/fno_{s}.cu" for s in sources],
                    "replaces": f"{SPLIT_SITE}:{SPLIT_ROWS[name][0]}", "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_s * 1e3,
                    "bound_by": "bytes" if nbytes / HBM_BPS >= fl / PEAK_FLOPS[prec]
                    else "operations",
                    "library_ms": None, "stage_launches_per_call": stages,
                    "bytes": nbytes, "flops": fl,
                }
        if prec == "highest":
            want = ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)
            want_g = ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD)
            got_g = ff.FastFNOParams(dwmr, dwmi, dpw, dpb, dw0t, db0, dw1t, db1, dw2t, db2)
            errs = {"pred": rel_err(pred, want)[1]}
            errs.update({f"d{n}": rel_err(a, b)[1]
                         for n, a, b in zip(ff.FastFNOParams._fields, got_g, want_g)})
            n_worst = max(errs, key=errs.get)
            check(max(errs.values()) <= TOL_SPLIT_CHAIN,
                  f"[split highest] the five chained vs the plain fused forward and VJP: worst "
                  f"rel-to-max {errs[n_worst]:.3e} ({n_worst}; tol {TOL_SPLIT_CHAIN:.0e})")
    spectral.set_dft_precision("default")
    for name, r in rows.items():
        ms_d, plain_d = timing[name, "default"]
        print(f"[timing] {card}: {name} (split, flagship): {r['ms']:.4f} ms/call `highest` "
              f"({ms_d:.4f} `default`), plain {r['plain_ms']:.4f} ms ({plain_d:.4f}), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} bytes, {r['flops']} FLOP "
              f"at 67 TFLOP/s f32)", flush=True)
    return rows


def probe_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 15: the ported perf probe, all eleven configs in this process
    with the launch counts set to 0 before and read after, then one config
    through the probe's own subprocess runner on its default device.
    Returns the launches of the split functions and the stage kernels."""
    import os

    import torch
    from sciml_pde_torch.experiments import perf_probe as pp
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    os.environ["PROBE_SCAN_K"] = str(PROBE_SCAN_K)
    fk.reset_launch_counts()
    ff.reset_split_counts()
    results = {}
    for name in pp.CONFIGS:
        t0 = time.perf_counter()
        results[name] = pp.run_config(name, dev)
        results[name]["wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(results[name]), flush=True)
    launches = {**ff.SPLIT_LAUNCHES, **fk.LAUNCHES}
    print(f"[probe] {card}: PROBE_SCAN_K {PROBE_SCAN_K}, PROBE_ITERS 20, flagship shape\n"
          + pp.table(results), flush=True)
    for name, res in results.items():
        check(pp.ok(res), f"[probe] {name}: no error, finite result"
              + (f" ({res['error']}: {res.get('error_lines', [])[-1:]})" if "error" in res
                 else ""))
    print(f"[probe] launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"[probe] the probe run launched {name} {n}x")
    out = run_dir / "perf_probe_main.json"
    pp.main(["--configs", "iso_headfwd", "--out", str(out)])
    res = json.loads(out.read_text())["iso_headfwd"]
    check(pp.ok(res) and res["device"] == torch.cuda.get_device_name(0),
          f"[probe] the subprocess runner on its default device: iso_headfwd "
          f"{res.get('steps_per_sec', float('nan')):.2f} calls/s on {res.get('device')}")
    return launches


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "sciml_pde_torch" / "ops" / "csrc").is_dir():
        print("FAIL: run from a checkout of the repository (sciml_pde_torch/ not found)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sciml_pde_torch.data.dr import DRBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.experiments.spectral_impl_bench import probe_native
    from sciml_pde_torch.ops import _build
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import probe as pb
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import default_init_tree, train_baseline

    # ---- 0. probe: the build and launch path, before anything is built on it --
    secs = _build.build_all(("probe",))
    pb.reset_launch_counts()
    probe_res = probe_native()
    probe_launches = pb.LAUNCHES["probe"]
    print(f"[probe] nvcc sm_90a probe.cu {secs:.2f} s; probe_native: {json.dumps(probe_res)}",
          flush=True)
    check(probe_res["native"] is True and probe_launches == 1,
          f"[probe] native kernel built, launched ({probe_launches}x) and exact")
    if not probe_res["native"]:
        print("FAIL: the native-kernel probe failed; nothing else is built", file=sys.stderr)
        return 1
    xp = torch.randn(8, 128, generator=torch.Generator().manual_seed(8)).cuda()
    yp = pb.probe(xp)
    check(bool(torch.equal(yp, pb.probe_plain(xp))), "[probe] probe(x) == 2 * x exactly")

    # ---- 1. card -------------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    # ---- 2. build ------------------------------------------------------------
    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[build] nvcc sm_90a, the other {len(_build.SOURCES) - 1} sources in parallel: "
          f"{secs:.2f} s", flush=True)
    usage = _build.ptxas_report("attention")
    for kern, regs, st, ld in usage:
        print(f"[build] attention.cu {kern}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads", flush=True)
    main_tc = [u for u in usage if u[0].endswith("tc_kernel<64>")]
    check(len(main_tc) == 3 and all(st == ld == 0 for _, _, st, ld in main_tc),
          "[build] the NS path's tensor-core attention kernels (head dim 64) spill nothing")

    # ---- 3. kernels vs plain versions ----------------------------------------
    g = torch.Generator().manual_seed(1)
    tree = default_init_tree(CC, MODES, WIDTH, T0, seed=1)
    p = ff.pack_params(tree, MODES, MODES, dev)
    store, grid = make_store(seed=0)
    win = torch.from_numpy(store[:B, :T0]).permute(0, 1, 4, 2, 3).contiguous().to(dev)
    grid2 = torch.from_numpy(grid).permute(2, 0, 1).contiguous().to(dev)
    cot = torch.randn(B, CC, XY, XY, generator=g).to(dev)
    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    # autograd of the plain forward in f32: shares no code with the VJP
    spectral.set_dft_precision("highest")
    pa = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
    (ff.fno2d_fused_reference(win, grid2, pa, MODES, MODES, PAD) * cot).sum().backward()
    plain_outs = {}
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        pk = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
        pred = ff.fno2d_fused_apply(win, grid2, pk, MODES, MODES, PAD)
        (pred * cot).sum().backward()
        want = ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)
        want_g = ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD)
        torch.cuda.synchronize()
        plain_outs[prec] = [want] + list(want_g)
        got_all = [pred.detach()] + [a.grad for a in pk]
        for name, got, ref in zip(names, got_all, plain_outs[prec]):
            err, rel = rel_err(got, ref)
            check(bool(torch.isfinite(got).all()) and rel <= TOL[prec],
                  f"[check {prec}] {name}: max abs err {err:.3e}, max rel-to-max err "
                  f"{rel:.3e} (tol {TOL[prec]:.0e})")
        for name, got, a in zip(names[1:], got_all[1:], pa):
            err, rel = rel_err(got, a.grad)
            check(rel <= TOL_AUTOGRAD[prec],
                  f"[check {prec}] {name} vs autograd of the f32 plain forward: max abs err "
                  f"{err:.3e}, max rel-to-max err {rel:.3e} (tol {TOL_AUTOGRAD[prec]:.0e})")
    # control: the `default` bound must tell bf16 dot inputs from f32 ones
    gaps = {n: rel_err(lo, hi)[1]
            for n, lo, hi in zip(names, plain_outs["default"], plain_outs["highest"])}
    print("[check] plain bf16-vs-f32 gap, rel-to-max: "
          + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items()), flush=True)
    check(max(gaps.values()) > 2 * TOL["default"],
          f"[check] the default tolerance {TOL['default']:.0e} lies below half the largest "
          f"bf16-vs-f32 gap ({max(gaps.values()):.3e})")

    # every kernel against its plain version on the main path's own inputs
    # (the shipped `default` precision): record the first call of each
    spectral.set_dft_precision("default")
    records: dict[str, tuple] = {}

    def recorder(fname):
        kfn = getattr(fk.KERNELS, fname)

        def call(*args, **kw):
            before = dict(fk.LAUNCHES)
            out = kfn(*args, **kw)
            for key in fk.KERNEL_NAMES:
                if fk.LAUNCHES[key] != before[key] and key not in records and key != "fno_reduce_rows":
                    records[key] = (fname, args, kw)
            return out
        return call

    from types import SimpleNamespace

    rec_ops = SimpleNamespace(**{n: recorder(n) for n in vars(fk.KERNELS)})
    pred, sv = ff._fused_forward(rec_ops, win, grid2, p, MODES, MODES, PAD, save=True)
    ff._fused_backward(rec_ops, cot, sv, p, MODES, MODES, PAD)
    # reduce_rows at the shape the head backward hands it
    nb_head = B * XY * XY // fk.HEAD_PB
    part = torch.randn(nb_head, NH * WIDTH + NH + CC * NH + CC, generator=g).to(dev)
    records["fno_reduce_rows"] = ("reduce_rows", (part,), {})
    torch.cuda.synchronize()

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in tensors(y)]
        return []

    def plain_call(fname, args, kw):
        return getattr(fk, f"{fname}_plain")(*args)

    def worst(outs_a, outs_b):
        worst_abs, worst_rel = 0.0, 0.0
        for a, b in zip(tensors(outs_a), tensors(outs_b)):
            e, r = rel_err(a, b)
            worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, r)
        return worst_abs, worst_rel

    def flops(key, fname, args, out):
        if fname == "stats":
            return 4 * args[0].numel()
        if fname == "lift":
            h0, finp = out
            return 2 * finp.numel() * h0.shape[1]
        if fname == "wdft":
            x, fac = args[0], args[1]
            return 2 * (x.numel() // fac.shape[0]) * fac.numel()
        if fname == "corner":
            a, (pr, _), (w, _), d = args[0], args[1], args[2], out[2]
            bsz, cin, hp, k2 = a.shape
            r, cout = pr.shape[1], d.shape[1]
            return bsz * (k2 // 2) * 8 * (cin * r * hp + cout * r * cin + cout * hp * r)
        if fname == "iwdft_pw":
            d, xin, o = args[0], args[2], out[0]
            return 2 * o.numel() * (d.shape[-1] + xin.shape[1])
        if fname == "head_fwd":
            hf, w1t, w2t, pr = args[0], args[1], args[3], out
            npix = pr.shape[0] * pr.shape[2] * pr.shape[3]
            return 2 * npix * (w1t.numel() + w2t.numel())
        if fname == "head_bwd":
            dpred, w1t, w2t = args[0], args[2], args[4]
            npix = dpred.shape[0] * dpred.shape[2] * dpred.shape[3]
            return 2 * npix * (3 * w1t.numel() + 2 * w2t.numel())
        if fname == "mix_wgrad":
            spr, dcr = args[0], args[2]
            return 8 * spr.numel() * dcr.shape[1]
        if fname == "outer":
            a, bm, nh, nw = args[0], args[1], args[3], args[4]
            return 2 * a.shape[0] * nh * nw * a.shape[1] * (bm.shape[1] + 1)
        if fname == "reduce_rows":
            return args[0].numel()
        raise KeyError(fname)

    def library_fn(key, fname, args):
        if key == "fno_stats":
            return lambda: torch.std_mean(args[0], dim=(1, 3, 4))
        if key in ("fno_wdft", "fno_wdft.adj"):
            return lambda: torch.matmul(args[0], args[1])
        if key == "fno_reduce_rows":
            return lambda: torch.sum(args[0], dim=0)
        return None

    kernel_rows = {}
    for key in fk.KERNEL_NAMES:
        fname, args, kw = records[key]
        kfn = getattr(fk, fname)
        out_k = kfn(*args, **kw)
        out_p = plain_call(fname, args, kw)
        worst_abs, worst_rel = worst(out_k, out_p)
        # control: the kernel lies nearer its plain version than the plain
        # version with f32 dot inputs does (kernels that take ``bf``)
        gap = None
        if fname not in ("stats", "mix_wgrad", "reduce_rows") and args[-1] is True:
            gap = worst(plain_call(fname, args[:-1] + (False,), kw), out_p)[1]
        torch.cuda.synchronize()
        check(worst_rel <= TOL_KERNEL and (gap is None or worst_rel < gap / 2),
              f"[kernel] {key}: max abs err {worst_abs:.3e}, rel-to-max {worst_rel:.3e} "
              f"(tol {TOL_KERNEL:.0e}; plain bf16-vs-f32 gap "
              + ("n/a" if gap is None else f"{gap:.3e}") + ")")
        in_bytes = sum(t.numel() * t.element_size() for t in tensors(args))
        out_bytes = sum(t.numel() * t.element_size() for t in tensors(out_k))
        fl = flops(key, fname, args, out_k)
        peak = PEAK_FLOPS[spectral.get_dft_precision()]
        bound_s = max((in_bytes + out_bytes) / HBM_BPS, fl / peak)
        lib = library_fn(key, fname, args)
        kernel_rows[key] = {
            "name": key, "route": "cuda",
            "source": f"sciml_pde_torch/ops/csrc/fno_{KERNEL_SOURCE[key]}.cu",
            "replaces": FWD_SITE if KERNEL_SOURCE[key] == "fwd" else BWD_SITE,
            "launches": 0, "max_abs_err": worst_abs,
            "ms": cuda_ms(lambda: kfn(*args, **kw)),
            "plain_ms": cuda_ms(lambda: plain_call(fname, args, kw)),
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if (in_bytes + out_bytes) / HBM_BPS >= fl / peak
            else "operations",
            "library_ms": cuda_ms(lib) if lib is not None else None,
        }

    fname, args, kw = records["fno_stats"]
    kernel_rows["fno_stats"]["device_ms"] = profiler_ms(lambda: fk.stats(*args), "stats_kernel")
    kernel_rows["fno_stats"]["library_device_ms"] = profiler_ms(library_fn("fno_stats", fname,
                                                                           args))
    check_stats(dev)

    # ---- 4. train: the main path, through the trainer -------------------------
    spectral.set_dft_precision("default")
    n_train = int(0.9 * N_TRAJ)
    ds = DRBaselineDataset(
        train=WindowedTrajectories(store[:n_train], grid, initial_step=T0, rollout=1,
                                   train=True, device=dev),
        test=WindowedTrajectories(store[n_train:], grid, initial_step=T0, rollout=1,
                                  train=False, device=dev),
    )
    run_dir = root / "runs" / "chip_smoke"
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_baseline(ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, learning_rate=1e-3, seed=0,
                         run_dir=str(run_dir), model_name="DR_smoke_FNO", log_every=0,
                         fast_step=True, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    h = res.history[0]
    steps = len(ds.train.window_index()) // B
    print(f"[train] {steps} steps + val in {train_s:.3f} s: first step loss "
          f"{h['first_step_loss']:.6g}, last step loss {h['last_step_loss']:.6g}, epoch "
          f"train loss {h['train_loss']:.6g}, val loss {h['val_loss']:.6g}", flush=True)
    finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                     (h["first_step_loss"], h["last_step_loss"], h["train_loss"],
                      h["val_loss"])))
    check(finite, "[train] losses finite")
    check(h["last_step_loss"] < h["first_step_loss"] and h["train_loss"] < h["first_step_loss"],
          "[train] loss falls (last step and epoch mean below the first step)")
    check((run_dir / "DR_smoke_FNO_ckpt.pt").exists(), "[train] best-val checkpoint written")
    print(f"[train] launches: {json.dumps(launches)}", flush=True)
    for key in fk.KERNEL_NAMES:
        kernel_rows[key]["launches"] = launches[key]
        check(launches[key] > 0, f"[train] main path launched {key} ({launches[key]}x)")

    # ---- 5. timing -----------------------------------------------------------
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    opt = fs.init_opt(theta)
    step, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
    data, grid2t = ds.train.data, ds.train.grid.permute(2, 0, 1).contiguous()
    idx = torch.as_tensor(ds.train.window_index()[:B], dtype=torch.long, device=dev)
    n_steps = 50
    for _ in range(5):
        theta, opt, _, _ = step(theta, opt, data, grid2t, idx)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n_steps):
        theta, opt, loss, _ = step(theta, opt, data, grid2t, idx)
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / n_steps
    check(bool(torch.isfinite(loss)), "[timing] loss finite")
    pf = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
    fwd_ms = cuda_ms(lambda: ff.fno2d_fused_apply(win, grid2, p, MODES, MODES, PAD))

    def fwd_bwd():
        (ff.fno2d_fused_apply(win, grid2, pf, MODES, MODES, PAD) * cot).sum().backward()
    fwd_bwd_ms = cuda_ms(fwd_bwd)
    print(f"[timing] {card}: fused step {step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s "
          f"(batch {B}, 128^2, width {WIDTH}, modes {MODES}, default precision)", flush=True)
    print(f"[timing] {card}: fused apply forward {fwd_ms:.4f} ms, forward+backward "
          f"{fwd_bwd_ms:.4f} ms", flush=True)
    def fno_steps():
        nonlocal theta, opt
        for _ in range(20):
            theta, opt, _, _ = step(theta, opt, data, grid2t, idx)
    device_profile(card, fno_steps, 20, "step", step_ms,
                   ("stats_kernel", "lift_kernel", "wdft_kernel", "corner_kernel",
                    "iwdft_pw_kernel", "head_fwd_kernel", "head_bwd_kernel",
                    "mix_wgrad_kernel", "outer_partial_kernel", "reduce_rows_kernel"))
    for key in fk.KERNEL_NAMES:
        r = kernel_rows[key]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if "device_ms" in r:
            lib += (" ms (profiler device time "
                    + ("not measured" if r["library_device_ms"] is None
                       else f"{r['library_device_ms']:.4f}")
                    + "), profiler device time "
                    + ("not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"))
        print(f"[timing] {card}: {key}: {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib} ms, "
              f"{r['launches']} launches in the epoch", flush=True)

    kernel_rows.update(transformer_path(dev, card, run_dir))
    kernel_rows.update(production_path(dev, card, run_dir, store, grid, tree, ds))

    # ---- 14. the split functions; 15. the probe, this slice's path -------------
    split_rows = split_path(dev, card, win, grid2, p, cot)
    path_launches = probe_path(dev, card, run_dir)
    for name, row in split_rows.items():
        row["launches"] = path_launches[name]
    kernel_rows.update(split_rows)
    bytes_s, ops_s = 2 * xp.numel() * 4 / HBM_BPS, xp.numel() / PEAK_FLOPS["highest"]
    kernel_rows["probe"] = {
        "name": "probe", "route": "cuda", "source": "sciml_pde_torch/ops/csrc/probe.cu",
        "replaces": PROBE_SITE, "launches": probe_launches,
        "max_abs_err": rel_err(yp, pb.probe_plain(xp))[0],
        "ms": cuda_ms(lambda: pb.probe(xp)), "plain_ms": cuda_ms(lambda: pb.probe_plain(xp)),
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": cuda_ms(lambda: torch.mul(xp, 2)),
    }
    r = kernel_rows["probe"]
    print(f"[timing] {card}: probe at (8, 128) f32: {r['ms']:.4f} ms/launch, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.7f} ms ({r['bound_by']}), library "
          f"{r['library_ms']:.4f} ms (torch.mul), {r['launches']} launch in probe_native",
          flush=True)

    if failures:
        print(f"FAILED {len(failures)} check(s): " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel_rows[k] for k in (*fk.KERNEL_NAMES, *ta.KERNEL_NAMES,
                                                            *sf.KERNEL_NAMES, *pb.KERNEL_NAMES,
                                                            *ff.SPLIT_NAMES)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
