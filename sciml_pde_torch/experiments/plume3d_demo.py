"""3D plume end-to-end demo: generation on the card + FNO3d aux training
(port of the JAX package's ``experiments/plume3d_demo.py``).

Production shapes (res 50x50x89, 150 frames — reference
generate_3D_plume.py defaults) at a reduced trajectory/epoch count; the
config_ns_3d presets are the same code path at full scale.

  python -m sciml_pde_torch.experiments.plume3d_demo --folder data/plume3d

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from sciml_pde_torch.experiments.plume3d_parity import generate, plume_configs
from sciml_pde_torch.train.fno_train import run_training


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folder", default="data/plume3d")
    p.add_argument("--res", type=int, nargs=3, default=[50, 50, 89])
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--substeps", type=int, default=10)
    p.add_argument("--n-primary", type=int, default=2)
    p.add_argument("--n-aux-per", type=int, default=3)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--initial-step", type=int, default=10)
    p.add_argument("--skip-gen", action="store_true")
    p.add_argument("--out", default="runs/plume3d")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device

    dev = resolve_device(a.device)
    folder = Path(a.folder)
    cfg, aux_cfg = plume_configs(a.res, a.frames, a.substeps)
    if not a.skip_gen:
        t0 = time.time()
        generate(folder, cfg, aux_cfg, range(a.n_primary), range(a.n_primary * a.n_aux_per),
                 (275,), dev, skip_existing=False)
        print(f"generation: {time.time()-t0:.0f}s", flush=True)

    out = Path(a.out)
    results = {}
    for variant in ["aux"]:
        t0 = time.time()
        res = run_training(
            base_path=str(folder), aux_path=str(folder), dataset_family="ns3d",
            if_aux=True,
            train_subsample=(a.n_primary, a.n_primary, a.n_primary * a.n_aux_per),
            num_aux_samples=a.n_aux_per, test_range=(275, 276),
            num_channels=4, modes=8, width=20, initial_step=a.initial_step,
            rollout_test=1, batch_size=1, epochs=a.epochs,
            run_dir=str(out), model_name=f"plume_{variant}", log_every=200, device=dev,
        )
        print(f"{variant}: best_val={res.best_val:.6f} in {time.time()-t0:.0f}s", flush=True)
        results[variant] = {"best_val": float(res.best_val), "history": res.history[-3:]}
        out.mkdir(parents=True, exist_ok=True)
        (out / "summary.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
