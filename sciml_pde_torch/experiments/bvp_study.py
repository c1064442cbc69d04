"""Electro/magneto-statics BVP study on generated point-cloud data (port of
the JAX package's ``experiments/bvp_study.py``).

``sim/bvp_2d.py`` regenerates the reference's FEM point-cloud protocol from
an exact DST-I Poisson solve (11-feature nodes -> potential, field_x,
field_y); this driver trains the irregular-point-set OFormer on both
physics with the reference recipe (squared pointwise loss, AMSGrad with
weight decay 1e-4, warmup-cosine, clip 2.0) and records the MSE test
metrics in ``{out}/summary.json``.

  python -m sciml_pde_torch.experiments.bvp_study --data data/bvp --epochs 160

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="runs/bvp_study")
    p.add_argument("--data", default="data/bvp")
    p.add_argument("--n-train", type=int, default=400)
    p.add_argument("--n-test", type=int, default=50)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--iters", type=int, default=0,
                   help="optimizer-step budget; 0 = epoch-budgeted "
                        "(reference default is 100k iterations)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--latent", type=int, default=64)
    p.add_argument("--kinds", nargs="+", default=["electro", "magneto"])
    p.add_argument("--tag", default="")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch.comparisons.pointset_bvp import (
        evaluate_pointset,
        run_pointset_training,
        standardize_features,
    )
    from sciml_pde_torch.models.oformer import OFormerIrreg2D
    from sciml_pde_torch.sim.bvp_2d import BVPConfig, generate_dataset, load_pointset

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}

    for kind in a.kinds:
        cfg = BVPConfig(kind=kind, grid=a.grid)
        train_p = Path(a.data) / f"{kind}_train.pkl"
        test_p = Path(a.data) / f"{kind}_test.pkl"
        t0 = time.time()
        if not train_p.exists():
            generate_dataset(train_p, a.n_train, cfg, seed0=0, device=a.device)
        if not test_p.exists():
            generate_dataset(test_p, a.n_test, cfg, seed0=10_000, device=a.device)
        gen_s = time.time() - t0
        train = load_pointset(train_p)
        test = load_pointset(test_p)
        # standardise features from TRAIN stats (the raw on-disk source
        # density column reaches O(1e3); see standardize_features)
        train, test, _stats = standardize_features(train, test)
        print(f"{kind}: train {train['features'].shape} test "
              f"{test['features'].shape} (gen {gen_s:.0f}s)", flush=True)

        t0 = time.time()
        res = run_pointset_training(
            train, latent_channels=a.latent, heads=1, depth=2,
            batch_size=a.batch_size, epochs=a.epochs, learning_rate=a.lr,
            reference_recipe=True, run_dir=str(out), log_every=200,
            total_steps=a.iters or None, device=a.device,
        )
        train_s = time.time() - t0
        model = OFormerIrreg2D(train["features"].shape[-1], latent_channels=a.latent,
                               heads=1, depth=2)
        ev = evaluate_pointset(model, res.params, test, device=a.device)
        key = f"{kind}_{a.tag}" if a.tag else kind
        results[key] = {
            **ev, "gen_seconds": gen_s, "train_seconds": train_s,
            "final_train_loss": res.history[-1]["loss"],
            "iters": a.iters or a.epochs * (train["features"].shape[0] // a.batch_size),
        }
        print(key, json.dumps(results[key], indent=1), flush=True)
        summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
