"""A/B of the spectral-conv forms on the card (port of
``experiments/spectral_impl_bench.py``).

    python -m sciml_pde_torch.experiments.spectral_impl_bench [--steps N] [--ns] [--out F]

Times full production FNO2d optimizer steps (gather + forward + backward +
adaptive clip + Adam) for impl in {dft, dft2} at the DR bench shape and,
with ``--ns``, the NS production shape, and probes whether a hand-written
CUDA kernel builds and runs on this machine at all (``probe_native``, which
launches ``ops/probe.py``).  Prints one JSON line for the probe and one
per shape.  Exit code 0 even if the probe fails: its result is data.
Each result names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.ops import spectral as S
from sciml_pde_torch.train.fno_train import build_baseline_step
from sciml_pde_torch.train.optim import make_optimizer


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_shape(name, batch, nx, channels, steps, windows=5, device=None) -> dict:
    """Median steps/s over ``windows`` windows of ``steps`` production
    steps each (host clock around work that ends in a device sync), for
    the ``dft`` and the ``dft2`` spectral conv, from the same seeded
    weights and batches.  The module default impl is restored after."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    initial_step, n_traj, n_frames = 10, 8, 32
    data = torch.as_tensor(
        rng.normal(size=(n_traj, n_frames, nx, nx, channels)).astype(np.float32), device=dev)
    lin = np.linspace(-1, 1, nx, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    grid = torch.as_tensor(np.stack([gx, gy], -1), device=dev)
    idx_pool = [
        torch.as_tensor(np.stack([rng.integers(0, n_traj, batch),
                                  rng.integers(0, n_frames - initial_step - 1, batch)], axis=1),
                        dtype=torch.long, device=dev)
        for _ in range(16)
    ]
    out = {"shape": name, "batch": batch, "nx": nx, "device": _device_name(dev)}
    prev = S.get_spectral_impl()
    try:
        for impl in ("dft", "dft2"):
            S.set_spectral_impl(impl)
            model = FNO2d(channels, 12, 12, 20, initial_step,
                          generator=torch.Generator().manual_seed(0)).to(dev)
            opt = make_optimizer(dict(model.named_parameters()), 1e-3, total_steps=10_000)
            step, _ = build_baseline_step(model, opt, initial_step, rollout=1)
            t0 = time.perf_counter()
            for _ in range(3):
                loss, _ = step(data, grid, idx_pool[0])
            _sync(dev)
            warmup_s = time.perf_counter() - t0
            rates = []
            for _ in range(windows):
                t0 = time.perf_counter()
                for s in range(steps):
                    loss, _ = step(data, grid, idx_pool[s % len(idx_pool)])
                _sync(dev)
                rates.append(steps / (time.perf_counter() - t0))
            out[impl] = {"steps_per_sec_median": float(np.median(rates)), "windows": rates,
                         "warmup_s": warmup_s, "final_loss": float(loss)}
            print(f"[{name}] {impl}: {out[impl]}", file=sys.stderr, flush=True)
    finally:
        S.set_spectral_impl(prev)
    out["speedup_dft2_vs_dft"] = (out["dft2"]["steps_per_sec_median"]
                                  / out["dft"]["steps_per_sec_median"])
    return out


def probe_native() -> dict:
    """Does a hand-written CUDA kernel build, launch and compute ``x * 2``
    here?  Any failure is reported as ``native: False`` with its error."""
    from sciml_pde_torch.ops.probe import probe

    cuda = torch.cuda.is_available()
    res = {"platform": "cuda" if cuda else "cpu",
           "device": torch.cuda.get_device_name(0) if cuda else None}
    try:
        x = torch.ones((8, 128), dtype=torch.float32, device="cuda")
        y = probe(x)
        torch.cuda.synchronize()
        res["native"] = bool(torch.equal(y.cpu(), torch.full((8, 128), 2.0)))
    except Exception as e:  # noqa: BLE001 - the probe result is data
        res["native"] = False
        res["error"] = f"{type(e).__name__}: {e}"[:300]
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ns", action="store_true", help="also run the NS 256^2 shape")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)

    results = {"probe": probe_native()}
    print(json.dumps(results["probe"]), flush=True)
    results["dr"] = bench_shape("dr", batch=4, nx=128, channels=2, steps=args.steps)
    print(json.dumps(results["dr"]), flush=True)
    if args.ns:
        results["ns"] = bench_shape("ns", batch=8, nx=256, channels=3,
                                    steps=max(args.steps // 4, 20))
        print(json.dumps(results["ns"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
