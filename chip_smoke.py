#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``sciml_pde_torch/ops/csrc`` and drives the port's two main paths through
their trainers: the fused FNO-2D diffusion-reaction baseline step (batch 4,
128x128, 2 channels, initial_step 10, width 20, modes 12), then the NS-2D
VideoMAE transformer baseline at full width (img 256, patch 16, tubelet 2,
3 channels, 10 frames -> 1280 tokens; encoder 768 x 12 with 12 heads,
decoder 512 x 8 with 8 heads, head dim 64; batch 2 x accumulation 4, bf16):

  1. card     name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc for sm_90a, all sources in parallel
  3. check    the fused forward and all ten gradients from the kernels
              against the plain PyTorch versions on the card, under
              `highest` (f32) and `default` (bf16 dot inputs); then every
              kernel against its own plain version on the inputs the main
              path gives it
  4. train    one epoch of the DR baseline on a seeded in-memory store
              (10 trajectories x 101 frames x 128 x 128 x 2): finite and
              falling loss, launch counts of every kernel
  5. timing   fused step steps/s and per-launch kernel times (CUDA events)
  6. attention the three flash-attention kernels against their plain
              versions at the encoder (24, 1280, 64) and decoder
              (16, 1280, 64) shapes, in f32 and bf16, with a control
              against a kernel that rounds p and ds to bf16
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
              per-launch attention kernel times beside their bounds

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
N_TRAJ, N_T = 10, 101
# kernels vs plain versions, error bound relative to the largest magnitude
# of the plain result: f32 sums in another order (highest); bf16 dot inputs
# whose rounding a different summation order can flip (default).  The
# default bound lies below the gap between bf16 and f32 inputs, which the
# run measures and checks, so a kernel that ignores its precision fails.
TOL = {"highest": 1e-4, "default": 2e-3}
TOL_KERNEL = 1e-3  # one kernel against its plain version, main-path inputs
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
    products at the card's peak for their input type): q.k^T and do.v^T
    take the input type; p.v, ds.k, ds^T.q and p^T.do take f32 p and ds
    (the CUDA cores' 67 TFLOP/s)."""
    es = 2 if bf else 4
    panel, row = bh * n * d * es, bh * n * 4
    prod = 2 * bh * n * n * d
    rate_in = PEAK_FLOPS["default" if bf else "highest"]
    rate_f32 = PEAK_FLOPS["highest"]
    if name == "attention_fwd":
        return 3 * panel + panel + row, prod / rate_in + prod / rate_f32
    if name == "attention_dq":
        return 4 * panel + 2 * row + panel, 2 * prod / rate_in + prod / rate_f32
    return 4 * panel + 2 * row + 2 * panel, 2 * prod / rate_in + 2 * prod / rate_f32


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
    """Phase 6: each kernel against its plain version at the encoder and
    decoder shapes in f32 and bf16.  Returns the bf16 encoder-shape inputs
    of each kernel (the main path's most frequent launch) for timing."""
    import torch

    g = torch.Generator().manual_seed(3)
    main_inputs = {}
    for where, (bh, n, d) in ATT_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
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
                want = as_tuple(getattr(ta, f"{name}_plain")(*args[name], scale))
                torch.cuda.synchronize()
                msgs, ok = [], True
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
                   ("fwd_kernel<", "dq_kernel<", "dkv_kernel<"))
    del model, opt, step, params

    sdpa = torch.nn.functional.scaled_dot_product_attention
    (q, k, v), scale = att_inputs["attention_fwd"]
    (_, _, _, do, _, _), _ = att_inputs["attention_dq"]
    bh, n, d = q.shape
    as4 = lambda t: t.view(NS_BATCH, bh // NS_BATCH, n, d)  # noqa: E731
    q4, k4, v4 = (as4(t).detach().requires_grad_(True) for t in (q, k, v))
    o4 = sdpa(q4, k4, v4, scale=scale)
    lib = {"attention_fwd": cuda_ms(lambda: sdpa(as4(q), as4(k), as4(v), scale=scale))}
    lib["attention_dq"] = lib["attention_dkv"] = cuda_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), as4(do), retain_graph=True))
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
        }
        r = rows[name]
        print(f"[timing] {card}: {name} at {tuple(q.shape)} bf16: {r['ms']:.4f} ms/launch, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"library {r['library_ms']:.4f} ms (scaled_dot_product_attention "
              f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV together'}), "
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

    return rows


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
    from sciml_pde_torch.ops import _build
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import default_init_tree, train_baseline

    # ---- 1. card -------------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    # ---- 2. build ------------------------------------------------------------
    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[build] nvcc sm_90a, {len(_build.SOURCES)} sources in parallel: "
          f"{secs:.2f} s", flush=True)

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
        if key == "fno_wdft":
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
                         device=dev)
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
    step = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
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
        lib ="n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[timing] {card}: {key}: {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib} ms, "
              f"{r['launches']} launches in the epoch", flush=True)

    kernel_rows.update(transformer_path(dev, card, run_dir))

    if failures:
        print(f"FAILED {len(failures)} check(s): " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel_rows[k] for k in (*fk.KERNEL_NAMES,
                                                            *ta.KERNEL_NAMES)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
