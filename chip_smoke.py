#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``sciml_pde_torch/ops/csrc`` and drives the port's main path, the fused
FNO-2D diffusion-reaction baseline step (batch 4, 128x128, 2 channels,
initial_step 10, width 20, modes 12), through the trainer:

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

It prints the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero and
prints no result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
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
    # device busy share of the step: kernel time on the card over wall time
    from torch.profiler import ProfilerActivity, profile

    n_prof = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            theta, opt, loss, _ = step(theta, opt, data, grid2t, idx)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
    busy_us = sum(ev.self_device_time_total for ev in evs)
    if busy_us > 0:
        ours = sum(ev.self_device_time_total for ev in evs if "_kernel" in ev.key
                   and any(n in ev.key for n in ("stats", "lift", "wdft", "corner", "iwdft",
                                                 "head_", "mix_wgrad", "outer", "reduce_rows")))
        print(f"[profile] {card}: {n_prof} steps, wall {wall_us / n_prof:.1f} us/step "
              f"(profiler on), device busy {busy_us / n_prof:.1f} us/step = "
              f"{100 * busy_us / wall_us:.1f}% (idle {100 - 100 * busy_us / wall_us:.1f}%), "
              f"of it the port's kernels {100 * ours / busy_us:.1f}%; device busy over the "
              f"unprofiled step {step_ms * 1e3:.1f} us = {100 * busy_us / n_prof / (step_ms * 1e3):.1f}%",
              flush=True)
        top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:12]
        for ev in top:
            print(f"[profile]   {ev.self_device_time_total / n_prof:9.1f} us/step "
                  f"{ev.count // n_prof:4d}x  {ev.key[:90]}", flush=True)
    else:
        print("[profile] the profiler recorded no device time: not measured", flush=True)
    for key in fk.KERNEL_NAMES:
        r = kernel_rows[key]
        lib ="n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[timing] {card}: {key}: {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib} ms, "
              f"{r['launches']} launches in the epoch", flush=True)

    if failures:
        print(f"FAILED {len(failures)} check(s): " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel_rows[k] for k in fk.KERNEL_NAMES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
