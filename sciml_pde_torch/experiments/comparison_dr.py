"""OFormer + Hyena comparison on the generated 2D DR dataset (port of the
JAX package's ``experiments/comparison_dr.py``).

64x64 single-channel fields flattened to point sets, ONE encode of the
first 10 frames, a 40-step latent-propagator rollout, standardised inputs
and targets, and the reference's five-number report (avg Rel-L2,
accumulated MSE a frame, final-step Rel-L2, rollout nRMSE, final nRMSE)
into ``{out}/summary.json``.  ``--legacy`` keeps the 1-step autoregressive
study.  The DR files come from ``python -m sciml_pde_torch.sim.gen_diff_react``.

  python -m sciml_pde_torch.experiments.comparison_dr --data data/ --epochs 100

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

EXT_FILE = "2D_diff-react_ext_all_100_299.h5"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--out", default="runs/comparison_dr")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--train-subsample", type=int, default=270)
    p.add_argument("--in-seq", type=int, default=10)
    p.add_argument("--out-seq", type=int, default=40)
    p.add_argument("--spatial-down", type=int, default=2)
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--rollout", type=int, default=5,
                   help="legacy-mode autoregressive steps")
    p.add_argument("--models", nargs="+", default=["oformer", "hyena"])
    p.add_argument("--legacy", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}

    extras = [EXT_FILE] if (Path(a.data) / EXT_FILE).exists() else None

    if a.legacy:
        from sciml_pde_torch.comparisons.oformer_dr2d import (
            evaluate_comparison,
            run_comparison_training,
        )

        for mt in a.models:
            t0 = time.time()
            res = run_comparison_training(
                base_path=a.data, model_type=mt,
                train_subsample=a.train_subsample, epochs=a.epochs,
                run_dir=str(out), model_name=f"{mt}_dr", device=a.device,
            )
            ev = evaluate_comparison(res.model, None, res.test_w, initial_step=10,
                                     rollout_steps=a.rollout)
            results[mt] = {**ev, "seconds": time.time() - t0}
            print(mt, results[mt], flush=True)
            summary_path.write_text(json.dumps(results, indent=1))
    else:
        from sciml_pde_torch.comparisons.oformer_dr2d import run_rollout_protocol

        for mt in a.models:
            t0 = time.time()
            m, _ = run_rollout_protocol(
                base_path=a.data, model_type=mt,
                in_seq_len=a.in_seq, out_seq_len=a.out_seq,
                spatial_down=a.spatial_down, channel=a.channel,
                train_subsample=a.train_subsample,
                extra_train_files=extras, batch_size=a.batch_size,
                epochs=a.epochs, run_dir=str(out),
                model_name=f"{mt}_dr_rollout", device=a.device,
            )
            results[f"{mt}_protocol"] = {**m, "seconds": time.time() - t0}
            print(mt, results[f"{mt}_protocol"], flush=True)
            summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
