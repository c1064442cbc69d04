"""Per-channel rollout diagnostic for the DR transformer v-channel artifact
(port of the JAX package's ``experiments/dr_vchannel_diag.py``).

Evaluates a trained checkpoint (``dr_transformer``'s
``vmae_dr_{key}_ckpt``) under both inference dtypes (bf16 / fp32) and
reports the per-channel nRMSE and the target's per-channel RMS at each
rollout horizon, from the reference's t0 = 0 test window (utils.py:
if_test -> (seed, 0)) and, for contrast, from a late window (t0 = 20) where
the inhibitor channel has grown to a healthy amplitude.

It separates two hypotheses for the r1 gap:
  - inference precision: fp32 inference on bf16-trained weights fixes v;
  - a training-side deficiency: both dtypes show the same v error.

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from sciml_pde_torch.experiments import _dr_vmae
from sciml_pde_torch.experiments._dr_vmae import per_channel_nrmse


def vchannel_rows(model, test, t0: int, rollout: int, device=None) -> dict[str, list]:
    """``r{k}``: the per-channel nRMSE of the k-th prediction from window
    ``t0``; ``r{k}_tgt_rms``: the target frame's per-channel RMS."""
    preds = _dr_vmae.roll(model, torch.as_tensor(test[:, t0:t0 + 10], device=device), rollout)
    row = {}
    for k in range(rollout):
        tgt = torch.as_tensor(test[:, t0 + 10 + k], device=device)
        row[f"r{k+1}"] = [float(v) for v in per_channel_nrmse(preds[k], tgt)]
        row[f"r{k+1}_tgt_rms"] = [float(v) for v in torch.sqrt(torch.mean(tgt**2,
                                                                          dim=(0, 1, 2)))]
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--ckpt",
                   default="runs/dr_transformer_r2/vmae_dr_basic_ds8_baseline_ckpt")
    _dr_vmae.add_width_args(p)
    p.add_argument("--rollout", type=int, default=3)
    p.add_argument("--t0", type=int, nargs="+", default=[0, 20])
    p.add_argument("--precisions", nargs="+", default=["bf16", "fp32"])
    p.add_argument("--out", default="runs/dr_transformer_r2/vchannel_diag.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.utils.checkpoint import restore_params

    dev = resolve_device(a.device)
    test = _dr_vmae.load_test(a.data)
    params, best_val = restore_params(Path(a.ckpt))
    print(f"ckpt best_val={best_val:.6f} test={test.shape}", flush=True)

    results = {}
    for prec in a.precisions:
        model = _dr_vmae.build(a, _dr_vmae.dtype_of(prec), params, dev)
        for t0 in a.t0:
            row = results[f"{prec}_t0={t0}"] = vchannel_rows(model, test, t0, a.rollout, dev)
            print(f"{prec} t0={t0}: "
                  + " ".join(f"r{k+1}=[u {row[f'r{k+1}'][0]:.4f}, v {row[f'r{k+1}'][1]:.4f}]"
                             for k in range(a.rollout)), flush=True)

    Path(a.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
