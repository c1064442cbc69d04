"""Point-set BVP and airfoil-class demo: train and evaluate on held-out
sets (port of the JAX package's ``experiments/pointset_bvp_demo.py``).

Drives the irregular point-set operators end to end on the synthetic
generators (``comparisons/pointset_bvp.synthetic_electrostatics`` /
``synthetic_vortex_sheet``) and records masked L1 / rel-L2 on held-out
samples in ``{out}/summary.json``.

  python -m sciml_pde_torch.experiments.pointset_bvp_demo --epochs 20

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
    p.add_argument("--out", default="runs/pointset_demo")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--n-train", type=int, default=96)
    p.add_argument("--n-test", type=int, default=16)
    p.add_argument("--max-points", type=int, default=128)
    p.add_argument("--cases", nargs="+", default=["bvp", "airfoil"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch.comparisons.pointset_bvp import (
        evaluate_airfoil,
        evaluate_pointset,
        run_airfoil_training,
        run_pointset_training,
        synthetic_electrostatics,
        synthetic_vortex_sheet,
    )
    from sciml_pde_torch.models.oformer import OFormerIrreg2D

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    results = {}

    if "bvp" in a.cases:
        train = synthetic_electrostatics(0, a.n_train, max_points=a.max_points)
        test = synthetic_electrostatics(1, a.n_test, max_points=a.max_points)
        t0 = time.time()
        res = run_pointset_training(train, epochs=a.epochs, run_dir=str(out), device=a.device)
        model = OFormerIrreg2D(train["features"].shape[-1], latent_channels=64, heads=1,
                               depth=2)
        ev = evaluate_pointset(model, res.params, test, device=a.device)
        results["bvp_electrostatics"] = {**ev, "seconds": time.time() - t0}
        print("bvp:", results["bvp_electrostatics"], flush=True)

    if "airfoil" in a.cases:
        train = synthetic_vortex_sheet(0, max(a.n_train // 2, 8))
        test = synthetic_vortex_sheet(1, max(a.n_test // 2, 4))
        t0 = time.time()
        res = run_airfoil_training(train, epochs=a.epochs, run_dir=str(out), device=a.device)
        ev = evaluate_airfoil(res.params, test, device=a.device)
        results["airfoil_vortex_sheet"] = {**ev, "seconds": time.time() - t0}
        print("airfoil:", results["airfoil_vortex_sheet"], flush=True)

    (out / "summary.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
