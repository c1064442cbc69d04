"""OFormer on self-generated PDEBench-format Burgers and Darcy data (port of
the JAX package's ``experiments/oformer_burgers_darcy.py``).

Generates the files with the port's simulators where they are missing
(``sim/burgers_1d.py``, ``sim/darcy_2d.py``), trains the OFormer on each and
records train and held-out relative L2 in ``{out}/summary.json``.

  python -m sciml_pde_torch.experiments.oformer_burgers_darcy --data data/ --epochs 10

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
    p.add_argument("--data", default="data/")
    p.add_argument("--out", default="runs/oformer_real")
    p.add_argument("--burgers-n", type=int, default=48)
    p.add_argument("--burgers-nx", type=int, default=256)
    p.add_argument("--darcy-n", type=int, default=192)
    p.add_argument("--darcy-nx", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--cases", nargs="+", default=["burgers", "darcy"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch.comparisons.oformer_generic import (
        eval_oformer_burgers,
        eval_oformer_darcy,
        load_pdebench_1d,
        run_oformer_burgers,
        run_oformer_darcy,
    )
    from sciml_pde_torch.sim.burgers_1d import generate_burgers_file
    from sciml_pde_torch.sim.darcy_2d import generate_darcy_file, load_pdebench_darcy

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}

    if "burgers" in a.cases:
        bpath = Path(a.data) / f"1D_Burgers_Sols_Nu0.01_{a.burgers_nx}.h5"
        if not bpath.exists():
            t0 = time.time()
            generate_burgers_file(bpath, n_samples=a.burgers_n, nx=a.burgers_nx,
                                  n_frames=101, t_final=2.0, seed=7, device=a.device)
            print(f"burgers gen: {time.time()-t0:.0f}s", flush=True)
        data = load_pdebench_1d(bpath)
        n_test = max(len(data) // 8, 1)
        t0 = time.time()
        res = run_oformer_burgers(data[:-n_test], epochs=a.epochs, run_dir=str(out),
                                  device=a.device)
        # held-out eval: next-step rel-L2 on the test trajectories
        test_rel = eval_oformer_burgers(res.params, data[-n_test:], device=a.device)
        results["burgers"] = {
            "train_rel_l2": res.history[-1]["rel_l2"],
            "test_rel_l2": float(test_rel),
            "seconds": time.time() - t0,
        }
        print("burgers:", results["burgers"], flush=True)

    if "darcy" in a.cases:
        dpath = Path(a.data) / f"2D_DarcyFlow_beta1.0_{a.darcy_nx}.h5"
        if not dpath.exists():
            t0 = time.time()
            generate_darcy_file(dpath, n_samples=a.darcy_n, nx=a.darcy_nx, seed=11,
                                device=a.device)
            print(f"darcy gen: {time.time()-t0:.0f}s", flush=True)
        af, uf = load_pdebench_darcy(dpath)
        n_test = max(len(af) // 8, 1)
        t0 = time.time()
        res = run_oformer_darcy(af[:-n_test], uf[:-n_test], epochs=a.epochs,
                                run_dir=str(out), device=a.device)
        test_rel = eval_oformer_darcy(res.params, af[-n_test:], uf[-n_test:],
                                      norm_stats=res.norm_stats, device=a.device)
        results["darcy"] = {
            "train_rel_l2": res.history[-1]["rel_l2"],
            "test_rel_l2": float(test_rel),
            "seconds": time.time() - t0,
        }
        print("darcy:", results["darcy"], flush=True)

    summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
