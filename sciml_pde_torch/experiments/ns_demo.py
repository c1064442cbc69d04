"""End-to-end 2D NS demonstration at reduced scale (port of the JAX
package's ``experiments/ns_demo.py``).

Generates a small NS dataset family on the device with the port's
generator (primary, convection-only aux and test files), then trains the
baseline and the aux FNO and scores the rollout nRMSE at horizons 1..5
into ``summary.json``: the reference's 2D-NS pipeline (gen_ns_incomp ->
FNODatasetMult -> fno_aux) at a scale that fits one card's hour.  The
production-scale run is ``experiments/ns_production.py``.  Runs on the
card; ``--device cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from sciml_pde_torch.sim.gen_ns_incomp import VARIANTS, generate_ns_file
from sciml_pde_torch.sim.ns_incomp_2d import NSIncompConfig


def generate(folder: Path, grid: int, frames: int, frame_int: int, n_primary: int,
             n_aux_per: int, n_test: int, test_start: int = 250, device=None):
    common = dict(grid_size=(grid, grid), nu=0.05, dt=5e-4, n_steps=frames * frame_int,
                  frame_int=frame_int, n_batch=2, cg_tol=1e-3, cg_max_iter=300)
    cfg = NSIncompConfig(**common)
    aux_cfg = NSIncompConfig(**common, **VARIANTS["convection"])
    folder.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    for i in range(n_primary):
        generate_ns_file(folder / f"ns_incom_inhom_2d_256-{i}.h5", i, cfg, device=device)
    for i in range(n_primary * n_aux_per):
        generate_ns_file(folder / f"ns_aux_2d_256-{i}.h5", 1000 + i, aux_cfg, device=device)
    for i in range(test_start, test_start + n_test):
        generate_ns_file(folder / f"ns_incom_inhom_2d_256-{i}.h5", i, cfg, device=device)
        generate_ns_file(folder / f"ns_aux_2d_256-{i}.h5", 2000 + i, aux_cfg, device=device)
    print(f"generation: {time.time()-t0:.0f}s", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folder", default="data/ns_demo")
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--frames", type=int, default=101)
    p.add_argument("--frame-int", type=int, default=20)
    p.add_argument("--n-primary", type=int, default=2)
    p.add_argument("--n-aux-per", type=int, default=3)
    p.add_argument("--n-test", type=int, default=2)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--skip-gen", action="store_true")
    p.add_argument("--out", default="runs/ns_demo")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device

    dev = resolve_device(a.device)
    folder = Path(a.folder)
    if not a.skip_gen:
        generate(folder, a.grid, a.frames, a.frame_int, a.n_primary, a.n_aux_per, a.n_test,
                 device=dev)

    from sciml_pde_torch.data.ns import load_ns_test
    from sciml_pde_torch.eval.rollout_experiment import rollout_study
    from sciml_pde_torch.models.fno import FNO2d, FNO2dAux
    from sciml_pde_torch.train.fno_train import run_training
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    out = Path(a.out)
    test_range = (250, 250 + a.n_test)
    test = load_ns_test(str(folder), initial_step=10, rollout_test=5, test_range=test_range,
                        device=dev)
    results = {}
    for variant in ["baseline", "aux"]:
        t0 = time.time()
        res = run_training(
            base_path=str(folder), aux_path=str(folder), dataset_family="ns",
            if_aux=(variant == "aux"),
            train_subsample=(a.n_primary, a.n_primary, a.n_primary * a.n_aux_per),
            num_aux_samples=a.n_aux_per, test_range=test_range,
            num_channels=3, modes=12, width=20, initial_step=10,
            batch_size=4 if variant == "baseline" else 2, epochs=a.epochs,
            run_dir=str(out), model_name=f"ns_{variant}", log_every=500, device=dev,
        )
        print(f"{variant}: best_val={res.best_val:.6f} in {time.time()-t0:.0f}s", flush=True)

        model = (FNO2dAux if variant == "aux" else FNO2d)(3, 12, 12, width=20, initial_step=10)
        model.load_state_dict(flax_to_state_dict(res.params))
        model = model.to(dev).eval()

        def apply_fn(x, g):
            return model(x, g, x, g)[0] if variant == "aux" else model(x, g)

        study = rollout_study(apply_fn, None, test, horizons=(1, 2, 3, 4, 5), batch_size=4,
                              out_path=out / f"rollout_ns_{variant}.json", device=dev)
        results[variant] = {
            "best_val": float(res.best_val),
            "rollout_nrmse": [study[k]["nRMSE"] for k in sorted(study)],
        }
        (out / "summary.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
