"""Which nRMSE convention produced the published DR transformer table?
(Port of the JAX package's ``experiments/dr_convention_eval.py``.)

The published rollout row (``Plot Generator/rollout.py:38``:
0.105883/0.109151/0.115661/0.12328/0.131266) cannot be reconciled with a
per-channel-normalised metric at the reference's own test protocol (t0 = 0
window, ``Baseline_rollout/utils.py``): the inhibitor channel at frame 10
has RMS ~0.018, so a per-channel score of 0.106 would need a dying
noise-seeded field fitted to ~10%.  The reference trainer's own loss and
val metric (``train_transformer_rd.py:64-70``) is nRMSE normalised jointly
over (C, H, W).

This diagnostic rolls trained checkpoints (``dr_transformer``'s
``vmae_dr_{key}_ckpt``) out from the t0 test window in bf16 and reports
the rollout-k tables under all four conventions:

  joint  x {final step, all unrolled steps}   (trainer val metric)
  perch  x {final step, all unrolled steps}   (metrics.py metric_func)

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from sciml_pde_torch.experiments import _dr_vmae

PUBLISHED = {
    "baseline": [0.105883, 0.109151, 0.115661, 0.12328, 0.131266],
    "aux": [0.0602556, 0.0709661, 0.0863324, 0.102376, 0.11813],
}
ROWS = ("joint_final", "joint_all", "perch_final", "perch_all")


def joint_nrmse(pred, tgt) -> float:
    """Reference train_transformer_rd.py:64-70: normalise over (C, H, W)
    jointly per sample, then the mean over the batch."""
    axes = tuple(range(1, pred.ndim))
    mse = torch.mean((pred - tgt) ** 2, dim=axes)
    denom = torch.mean(tgt**2, dim=axes) + 1e-7
    return float(torch.mean(torch.sqrt(mse) / torch.sqrt(denom)))


def perch_nrmse(pred, tgt) -> float:
    """Reference metrics.py metric_func: normalised per (sample, channel),
    averaged over channels and batch (channels last)."""
    axes = tuple(range(1, pred.ndim - 1))
    rmse = torch.sqrt(torch.mean((pred - tgt) ** 2, dim=axes))
    nrm = torch.sqrt(torch.mean(tgt**2, dim=axes)) + 1e-7
    return float(torch.mean(rmse / nrm))


def convention_rows(model, test, t0: int, rollout: int, device=None) -> dict[str, list]:
    """The four rows for ``model`` from window ``t0`` of every test
    trajectory (``test`` (N, T, H, W, C))."""
    x0 = torch.as_tensor(test[:, t0:t0 + 10], device=device)
    preds = _dr_vmae.roll(model, x0, rollout)
    tgts = [torch.as_tensor(test[:, t0 + 10 + k], device=device) for k in range(rollout)]
    row = {c: [] for c in ROWS}
    for k in range(rollout):
        row["joint_final"].append(joint_nrmse(preds[k], tgts[k]))
        row["perch_final"].append(perch_nrmse(preds[k], tgts[k]))
        # all steps: frames 1..k+1 scored together, time stacked on the batch
        pa, ta = torch.cat(preds[:k + 1]), torch.cat(tgts[:k + 1])
        row["joint_all"].append(joint_nrmse(pa, ta))
        row["perch_all"].append(perch_nrmse(pa, ta))
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--ckpts", nargs="+", default=[
        "baseline=runs/dr_transformer_r2/vmae_dr_basic_ds8_baseline_ckpt",
        "aux=runs/dr_transformer_r2/vmae_dr_basic_ds8_aux_v2_ckpt",
    ], help="name=path pairs; name picks the published row to compare")
    _dr_vmae.add_width_args(p)
    p.add_argument("--rollout", type=int, default=5)
    p.add_argument("--t0", type=int, default=0)
    p.add_argument("--out", default="runs/dr_transformer_r2/convention_eval.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.utils.checkpoint import restore_params

    dev = resolve_device(a.device)
    test = _dr_vmae.load_test(a.data)
    results = {}
    for spec in a.ckpts:
        name, path = spec.split("=", 1)
        if not Path(path).exists():
            print(f"skip {name}: no checkpoint at {path}", flush=True)
            continue
        params, best_val = restore_params(Path(path))
        model = _dr_vmae.build(a, torch.bfloat16, params, dev)
        row = convention_rows(model, test, a.t0, a.rollout, dev)
        row["best_val"] = float(best_val)
        row["published"] = PUBLISHED.get(name)
        results[name] = row
        print(f"== {name} (best_val {best_val:.4f}) ==", flush=True)
        for c in ROWS:
            print(f"  {c:12s} " + " ".join(f"{v:.4f}" for v in row[c]), flush=True)
        if row["published"]:
            print(f"  {'published':12s} " + " ".join(f"{v:.4f}" for v in row["published"]),
                  flush=True)

    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
