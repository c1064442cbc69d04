"""Step and split-kernel probe (port of ``experiments/perf_probe.py``).

    python -m sciml_pde_torch.experiments.perf_probe [--configs a,b] [--device cpu]
        [--out F] [--timeout S]

Measures the FNO-2D training steps and the five split kernels of
``ops/fno_fused_step.py`` at the flagship shape (batch 4, 128^2, 2
channels, initial_step 10, width 20, modes 12) and writes every config's
result to ``--out`` (merged with the results already there).  Each config
runs in its own subprocess under ``--timeout``, so that a failure in one
cannot cost the others; a config's error is recorded in its result.

Configs (the JAX probe's names):
  prod_f32      production step (``build_baseline_step``), ``step.scan`` of
                PROBE_SCAN_K steps, `highest`
  prod_bf16     the same under `default` (bf16 dot inputs)
  iso_bbfwd     ``_bb_forward`` alone        iso_headfwd  ``_head_forward``
  iso_headbwd   ``_head_backward`` alone     iso_bbbwd    ``_bb_backward``
  iso_wgrad     ``_bb_weight_grads`` alone
  fused_f32     fused step (``build_fast_baseline_step``), its scan, `highest`
  fused_bf16    the same under `default`
  fused_fwd     100-step rollout of ``fno2d_fused_apply``, no grad
  fused_b64     fused step at batch 64

Knobs, as in the JAX probe: PROBE_NX and PROBE_MODES shrink the geometry
(a CPU run of the probe's own plumbing), PROBE_SCAN_K steps per scan (200),
PROBE_ITERS calls per iso window (20).  Parameters come from
``default_init_tree`` (seeded), data and iso inputs from
``numpy.random.default_rng(0)``; iso inputs take the logical field shape.
Every timing window ends with a device-to-host value fetch, which waits
for the card.  ``compile_s`` is the first call's time (the kernels' build
and load included).  Each result names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.ops import fno_fused_step as ffs
from sciml_pde_torch.ops import spectral
from sciml_pde_torch.train import fast_step as fs
from sciml_pde_torch.train.fno_train import build_baseline_step, default_init_tree
from sciml_pde_torch.train.optim import make_optimizer
from sciml_pde_torch.utils.weights import flax_to_state_dict

_REPO = Path(__file__).resolve().parents[2]
BATCH, NX, T0, CC = 4, 128, 10, 2
MODES, WIDTH, PAD = 12, 20, 2
N_TRAJ, N_FRAMES, ROLLOUT_K, SEED = 8, 32, 100, 0
OUT = _REPO / "runs" / "perf_probe" / "perf_probe.json"

CONFIGS = {
    "prod_f32": {"kind": "prod", "prec": "highest"},
    "prod_bf16": {"kind": "prod", "prec": "default"},
    "iso_bbfwd": {"kind": "iso", "prec": "highest", "which": "bbfwd"},
    "iso_headfwd": {"kind": "iso", "prec": "highest", "which": "headfwd"},
    "iso_headbwd": {"kind": "iso", "prec": "highest", "which": "headbwd"},
    "iso_bbbwd": {"kind": "iso", "prec": "highest", "which": "bbbwd"},
    "iso_wgrad": {"kind": "iso", "prec": "highest", "which": "wgrad"},
    "fused_f32": {"kind": "fused", "prec": "highest"},
    "fused_bf16": {"kind": "fused", "prec": "default"},
    "fused_fwd": {"kind": "fused_fwd", "prec": "highest"},
    "fused_b64": {"kind": "fused", "prec": "highest", "batch": 64},
}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _iso_call(which: str, batch: int, nx: int, modes: int, tree, grid2, rng, dev):
    """One split function on seeded inputs: returns (fn, args)."""
    p = ffs.pack_params(tree, modes, modes, dev)
    hp = nx + PAD

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    win = normal(batch, T0, CC, nx, nx)
    bbout = normal(batch, WIDTH, nx, nx)
    stats = torch.stack([torch.zeros(batch, CC, device=dev),
                         torch.ones(batch, CC, device=dev)], -1)
    pre = normal(batch, ffs.L_LAYERS, WIDTH, hp, hp)
    h0p = normal(batch, WIDTH, hp, hp)
    dpred = normal(batch, CC, nx, nx)
    if which == "bbfwd":
        return (lambda w: ffs._bb_forward(w, grid2, p, modes, modes, PAD)[1]), (win,)
    if which == "headfwd":
        return (lambda bb, st: ffs._head_forward(bb, st, p)), (bbout, stats)
    if which == "headbwd":
        return (lambda dp, bb, st: ffs._head_backward(dp, bb, st, p)[0]), (dpred, bbout, stats)
    if which == "bbbwd":
        return (lambda db, pr, w, st: ffs._bb_backward(db, pr, w, grid2, st, p, modes, modes,
                                                       PAD)[0]), (bbout, pre, win, stats)
    return (lambda pr, h0, dp: ffs._bb_weight_grads(pr, h0, dp, p, modes, modes, PAD, nx,
                                                    nx)[0]), (pre, h0p, pre)


def run_one(name: str, device=None) -> dict:
    """Run one config under the current dft precision; returns its result."""
    cfg = CONFIGS[name]
    dev = resolve_device(device)
    batch = cfg.get("batch", BATCH)
    nx = int(os.environ.get("PROBE_NX", NX))
    modes = int(os.environ.get("PROBE_MODES", MODES))
    k = int(os.environ.get("PROBE_SCAN_K", "200"))
    rng = np.random.default_rng(SEED)
    data = torch.as_tensor(rng.normal(size=(N_TRAJ, N_FRAMES, nx, nx, CC)).astype(np.float32),
                           device=dev)
    lin = np.linspace(-1, 1, nx, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    grid = torch.as_tensor(np.stack([gx, gy], -1), device=dev)
    grid2 = grid.permute(2, 0, 1).contiguous()
    chunk = torch.as_tensor(
        np.stack([rng.integers(0, N_TRAJ, (k, batch)),
                  rng.integers(0, N_FRAMES - T0 - 1, (k, batch))], axis=2),
        dtype=torch.long, device=dev)
    tree = default_init_tree(CC, modes, WIDTH, T0, seed=SEED)
    res = {"config": name, "batch": batch, "scan_k": k, "device": _device_name(dev)}

    kind = cfg["kind"]
    if kind == "prod":
        model = FNO2d(CC, modes, modes, WIDTH, T0)
        model.load_state_dict(flax_to_state_dict(tree))
        model.to(dev)
        opt = make_optimizer(dict(model.named_parameters()), 1e-3, total_steps=10_000)
        step, _ = build_baseline_step(model, opt, T0, rollout=1)

        def run():
            return step.scan(data, grid, chunk)[0][-1]
        n = k
    elif kind == "fused":
        theta, spec = fs.fast_state_from_tree(tree, modes, dev)
        _, fscan = fs.build_fast_baseline_step(modes, T0, spec, 1e-3, 10_000)
        state = [theta, fs.init_opt(theta)]

        def run():
            state[0], state[1], losses, _ = fscan(state[0], state[1], data, grid2, chunk)
            return losses[-1]
        n = k
    elif kind == "iso":
        fn, args = _iso_call(cfg["which"], batch, nx, modes, tree, grid2, rng, dev)

        def run():
            return fn(*args)
        n = int(os.environ.get("PROBE_ITERS", "20"))
    else:  # fused_fwd: the forward-only rollout shape
        p = ffs.pack_params(tree, modes, modes, dev)
        win0 = torch.as_tensor(rng.normal(size=(batch, T0, CC, nx, nx)).astype(np.float32),
                               device=dev)

        @torch.no_grad()
        def run():
            w = win0
            for _ in range(ROLLOUT_K):
                pred = ffs.fno2d_fused_apply(w, grid2, p, modes, modes, PAD)
                w = torch.cat([w[:, 1:], pred[:, None]], dim=1)
            return pred
        n = res["scan_k"] = ROLLOUT_K

    # one call per window runs n steps; an iso window is n calls
    calls = n if kind == "iso" else 1
    t0 = time.perf_counter()
    first = float(run().sum())
    res["compile_s"] = time.perf_counter() - t0
    if kind in ("prod", "fused"):
        res["final_loss"] = first
    else:
        res["finite"] = bool(np.isfinite(first))
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = run()
        float(out.sum())
        rates.append(n / (time.perf_counter() - t0))
    res["steps_per_sec"] = float(np.median(rates))
    res["steps_per_sec_windows"] = [round(r, 1) for r in rates]
    res["step_ms"] = 1000.0 / res["steps_per_sec"]
    return res


def run_config(name: str, device=None) -> dict:
    """One config under its dft precision (the caller's is restored after);
    an exception becomes the result's ``error`` (its type) and
    ``error_lines`` (the traceback's end)."""
    prev = spectral.get_dft_precision()
    spectral.set_dft_precision(CONFIGS[name]["prec"])
    try:
        return run_one(name, device)
    except Exception as e:  # noqa: BLE001 - the boundary of one config: its error is data
        lines = "".join(traceback.format_exception(e)).splitlines()
        return {"config": name, "error": type(e).__name__, "error_lines": lines[-12:]}
    finally:
        spectral.set_dft_precision(prev)


def ok(res: dict) -> bool:
    """A config ran: no error, and its loss or output is finite."""
    return "error" not in res and bool(res.get("finite", np.isfinite(res.get("final_loss",
                                                                             np.nan))))


def table(results: dict) -> str:
    rows = [f"{'config':12s} {'steps/s':>10s} {'step ms':>10s} {'first s':>8s}  device"]
    for name, r in results.items():
        if "error" in r:
            rows.append(f"{name:12s} error {r['error']}")
            continue
        rows.append(f"{name:12s} {r['steps_per_sec']:10.2f} {r['step_ms']:10.4f} "
                    f"{r['compile_s']:8.2f}  {r['device']}")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="run ONE config (subprocess mode)")
    ap.add_argument("--timeout", type=int, default=900, help="per-config budget, seconds")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT), help="JSON results file")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    if a.config:
        print("PROBE_RESULT " + json.dumps(run_config(a.config, dev)), flush=True)
        return

    out = Path(a.out)
    try:
        results = json.loads(out.read_text())
    except (OSError, ValueError):
        results = {}
    env = {**os.environ,
           "PYTHONPATH": str(_REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for name in a.configs.split(","):
        cmd = [sys.executable, "-m", "sciml_pde_torch.experiments.perf_probe", "--config", name,
               "--device", dev.type]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=a.timeout,
                                  env={**env, "SCIML_DFT_PRECISION": CONFIGS[name]["prec"]},
                                  cwd=_REPO)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE_RESULT ")]
            if line:
                results[name] = json.loads(line[-1][len("PROBE_RESULT "):])
            else:
                results[name] = {"config": name, "error": f"rc={proc.returncode}",
                                 "tail": (proc.stderr or proc.stdout or "")[-2000:]}
        except subprocess.TimeoutExpired:
            results[name] = {"config": name, "error": "timeout"}
        results[name]["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(results[name]), flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(table(results), flush=True)
    print("probe complete ->", out, flush=True)


if __name__ == "__main__":
    main()
