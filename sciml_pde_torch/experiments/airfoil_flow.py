"""Airfoil point-cloud study: generate, train and evaluate (port of the JAX
package's ``experiments/airfoil_flow.py``).

Data from the port's compressible-Euler airfoil generator
(``sim/airfoil_2d.py``): randomised Mach/AoA/NACA-shape trajectories,
standardised (vx, vy, prs, dns) node states on scattered meshes, windowed
training (time_window -> forward_steps) of ``OFormerIrregST2D``, held-out
L1 and rel-L2 in ``{out}/summary.json``.

  python -m sciml_pde_torch.experiments.airfoil_flow --data data/airfoil --epochs 20

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
    p.add_argument("--out", default="runs/airfoil_flow")
    p.add_argument("--data", default="data/airfoil")
    p.add_argument("--n-train", type=int, default=12)
    p.add_argument("--n-test", type=int, default=4)
    p.add_argument("--nx", type=int, default=384)
    p.add_argument("--frames", type=int, default=61)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--time-window", type=int, default=4)
    p.add_argument("--forward-steps", type=int, default=2)
    p.add_argument("--emb-dim", type=int, default=96)
    p.add_argument("--latent", type=int, default=96)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--skip-gen", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch.comparisons.pointset_bvp import evaluate_airfoil, run_airfoil_training
    from sciml_pde_torch.sim.airfoil_2d import (
        AirfoilConfig,
        generate_dataset,
        load_airfoil_dataset,
    )

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    train_dir, test_dir = Path(a.data) / "train", Path(a.data) / "test"
    base = AirfoilConfig(nx=a.nx, ny=a.nx, n_frames=a.frames)

    if not a.skip_gen:
        t0 = time.time()
        generate_dataset(str(train_dir), list(range(a.n_train)), base, device=a.device)
        generate_dataset(str(test_dir), list(range(1000, 1000 + a.n_test)), base,
                         device=a.device)
        print(f"generation: {time.time() - t0:.1f}s", flush=True)

    train = load_airfoil_dataset(str(train_dir))
    test = load_airfoil_dataset(str(test_dir), n_points=train["fields"].shape[2])
    kw = dict(
        time_window=a.time_window, forward_steps=a.forward_steps,
        emb_dim=a.emb_dim, latent_channels=a.latent, depth=a.depth,
    )
    t0 = time.time()
    res = run_airfoil_training(train, epochs=a.epochs, run_dir=str(out), device=a.device, **kw)
    ev = evaluate_airfoil(res.params, test, device=a.device, **kw)
    results = {
        "airfoil_euler": {
            **ev,
            "seconds": time.time() - t0,
            "n_train": a.n_train,
            "n_test": a.n_test,
            "nodes": int(train["fields"].shape[2]),
        }
    }
    (out / "summary.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
