"""Accuracy gate for bf16 spectral contractions (SCIML_DFT_PRECISION); port
of the JAX package's ``experiments/dft_precision_gate.py``.

``SCIML_DFT_PRECISION=default`` rounds the inputs of the partial-DFT
chain's products to bf16; ``highest`` keeps them exact f32.  This driver
trains the SAME DR preset once per precision mode (identical seed, budget
and data) and compares best-val and the rollout-1..5 table; the gate
PASSES if every rollout-horizon nRMSE degrades by less than ``--tol``
(relative).  ``SCIML_FAST_STEP=1`` trains on the fused step (the
hand-written FNO kernels) instead of the production step.

  python -m sciml_pde_torch.experiments.dft_precision_gate --data data/ \\
      --dataset basic_ds8

Runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def gate_summary(results: dict, tol: float) -> dict:
    """The verdict from ``results[mode]`` = {best_val, train_seconds,
    rollout_nrmse} for "highest" and "default": each horizon's relative
    degradation, PASS where the largest is at most ``tol``."""
    ref = results["highest"]["rollout_nrmse"]
    got = results["default"]["rollout_nrmse"]
    rel = [(g - r) / r for r, g in zip(ref, got)]
    speedup = results["highest"]["train_seconds"] / max(results["default"]["train_seconds"],
                                                        1e-9)
    return {
        "highest": results["highest"],
        "default": results["default"],
        "relative_degradation_r1_5": rel,
        "tol": tol,
        "train_speedup": speedup,
        "verdict": "PASS" if max(rel) <= tol else "FAIL",
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--dataset", default="basic_ds8")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--modes", type=int, default=None, help="override config")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--tol", type=float, default=0.03,
                   help="max relative nRMSE degradation per horizon")
    p.add_argument("--out", default="runs/dft_precision_gate")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.data.dr import load_dr_test
    from sciml_pde_torch.eval.rollout_experiment import rollout_study
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops.spectral import set_dft_precision
    from sciml_pde_torch.train.cli import _call_with_supported
    from sciml_pde_torch.train.fno_train import run_training
    from sciml_pde_torch.utils.config import load_config
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    dev = resolve_device(a.device)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    results: dict = {}
    for mode in ("highest", "default"):
        set_dft_precision(mode)
        cfg = load_config("config_dr", a.dataset)
        cfg.update(base_path=a.data, aux_path=a.data, epochs=a.epochs, run_dir=str(out),
                   model_name=f"gate_{mode}", log_every=1000, device=dev)
        if a.modes:
            cfg["modes"] = a.modes
        if a.width:
            cfg["width"] = a.width
        t0 = time.time()
        res = _call_with_supported(run_training, cfg, if_aux=False)
        train_s = time.time() - t0

        test = load_dr_test(a.data, initial_step=cfg["initial_step"], rollout_test=5,
                            device=dev)
        model = FNO2d(cfg.get("num_channels", 2), cfg["modes"], cfg["modes"],
                      width=cfg["width"], initial_step=cfg["initial_step"])
        model.load_state_dict(flax_to_state_dict(res.params))
        model = model.to(dev).eval()
        study = rollout_study(lambda x, g: model(x, g), None, test, horizons=(1, 2, 3, 4, 5),
                              batch_size=5, out_path=out / f"rollout_{mode}.json", device=dev)
        results[mode] = {
            "best_val": float(res.best_val),
            "train_seconds": train_s,
            "rollout_nrmse": [study[k]["nRMSE"] for k in sorted(study)],
        }
        print(mode, json.dumps(results[mode]), flush=True)

    summary = gate_summary(results, a.tol)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k not in ("highest", "default")},
                     indent=1))
    worst = max(summary["relative_degradation_r1_5"])
    print(f"GATE {summary['verdict']}: bf16-dft max degradation {worst*100:.2f}% "
          f"(tol {a.tol*100:.0f}%), speedup x{summary['train_speedup']:.2f}")
    return summary


if __name__ == "__main__":
    main()
