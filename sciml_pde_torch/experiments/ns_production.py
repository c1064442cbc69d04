"""Production-shape 2D NS experiment: 256^2, 1000 frames, the reference's
physics (port of the JAX package's ``experiments/ns_production.py``).

The reference's production NS datasets are 256^2 x 1000-frame trajectories
(4 a file), dt 5e-5, frame_int 100, nu 0.05 (``data_gen/configs/
ns_incomp.yaml:10-58``); training follows config_ns (initial_step 10,
batch 16 baseline / 8 aux, 20 epochs, cosine; config_ns.yaml:19,27: the
aux step is 8 primary + 8 * num_aux_samples aux windows).  This driver
generates a basic_dsN-scale family of those files with the port's own
generator (``sim/gen_ns_incomp.py``: full-physics primaries,
convection-only aux, test files at index 250+), trains the baseline and
aux FNO, and runs the rollout study (``eval/rollout_experiment.py``) into
``summary.json``, with JAX's keys.

A store larger than the card stays in host RAM with ``--host-stream``
(batches gathered on the host, streamed through pinned buffers) or
``--resident-rotate R`` (one 1/R slice on the card at a time, swapped
between epochs under ``--rotate-schedule``).  Runs on the card;
``--device cpu`` runs the plain PyTorch versions on the CPU.

  python -m sciml_pde_torch.experiments.ns_production --folder data/ns_production \\
      --host-stream
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from sciml_pde_torch.sim.gen_ns_incomp import VARIANTS, generate_ns_file
from sciml_pde_torch.sim.ns_incomp_2d import NSIncompConfig


def make_cfg(grid: int, frames: int, frame_int: int, n_batch: int, variant: str,
             dt: float, nu: float, diffusion_mode: str = "explicit") -> NSIncompConfig:
    kw = dict(VARIANTS[variant])
    nu = kw.pop("nu", nu)
    return NSIncompConfig(
        grid_size=(grid, grid), nu=nu, dt=dt, n_steps=frames * frame_int,
        frame_int=frame_int, n_batch=n_batch, diffusion_mode=diffusion_mode, **kw,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folder", default="data/ns_production")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--frame-int", type=int, default=10)
    p.add_argument("--dt", type=float, default=5e-4)
    p.add_argument("--nu", type=float, default=0.05)
    p.add_argument("--diffusion-mode", choices=["explicit", "exact"], default="exact",
                   help="exact (expm propagator) lifts the explicit dt limit: "
                        "dt 5e-4 x frame_int 10 = the reference's 5e-3 frame "
                        "spacing at 1/10th the steps")
    p.add_argument("--n-batch", type=int, default=4)
    p.add_argument("--n-primary", type=int, default=2)
    p.add_argument("--n-primary-aux", type=int, default=0,
                   help="primary files for the AUX variant (0 = same as "
                        "--n-primary); the reference presets halve it "
                        "(config_ns.yaml basic_ds8: [2, 1, 24])")
    p.add_argument("--n-aux-per", type=int, default=3)
    p.add_argument("--aux-grid", type=int, default=0,
                   help="resolution of the generated aux files (0 = primary "
                        "--grid); a lower-resolution aux store is upsampled "
                        "to the primary grid inside the train step (the "
                        "reference's if_downsample gather, utils_2d_ns.py:139-161)")
    p.add_argument("--aux-chunks", type=int, default=1,
                   help="run the aux stream in K recomputed chunks a step")
    p.add_argument("--aux-compute", choices=["upsample", "native"], default="upsample",
                   help="'upsample' = the reference's gather-time linear "
                        "interpolation to the primary grid; 'native' = run the "
                        "aux stream at the store's resolution")
    p.add_argument("--n-test", type=int, default=1)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = the reference's per-variant defaults (16 baseline "
                        "/ 8 aux, config_ns.yaml:19)")
    p.add_argument("--host-stream", action="store_true",
                   help="keep the train stores in host RAM and stream window "
                        "batches to the card")
    p.add_argument("--aux-store-dtype", default="bf16", choices=["bf16", "f32"],
                   help="dtype of the aux trajectory store (primary data and "
                        "all metrics stay f32)")
    p.add_argument("--primary-store-dtype", default="f32", choices=["bf16", "f32"],
                   help="dtype of the primary TRAIN store (aux variant only)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the 4 spectral blocks in the backward pass")
    p.add_argument("--frames-per-chunk", type=int, default=20,
                   help="frames a chunk during generation, streamed into the "
                        "file (0 = the whole trajectory at once)")
    p.add_argument("--resident-rotate", type=int, default=0,
                   help="R>1: keep the full train pool in host RAM and rotate "
                        "a 1/R trajectory slice on the card per epoch (epochs "
                        "are per slice, so R*N epochs = N full passes)")
    p.add_argument("--rotate-schedule", default="block",
                   choices=["block", "interleave", "cyclic"],
                   help="slice schedule: block = one segment a slice (R-1 "
                        "swaps a run, one LR band a slice), interleave = two "
                        "half-run passes (2R-1 swaps, both LR bands), cyclic "
                        "= every epoch")
    p.add_argument("--skip-gen", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore the best-val checkpoint "
                        "(<out>/ns_prod_<variant><tag>_ckpt) and write the "
                        "rollout table")
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--variants", nargs="+", default=["baseline", "aux"],
                   help="baseline | aux | lie (baseline + Lie point-symmetry "
                        "augmentation); 'none' = generate the data family and exit")
    p.add_argument("--tag", default="",
                   help="suffix for model_name and summary keys")
    p.add_argument("--out", default="runs/ns_production")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    tag = f"_{a.tag}" if a.tag else ""

    from sciml_pde_torch._device import resolve_device

    dev = resolve_device(a.device)
    folder = Path(a.folder)
    n_primary_aux = a.n_primary_aux or a.n_primary
    aux_grid = a.aux_grid or a.grid
    aux_name = f"ns_aux_2d_{aux_grid}" if aux_grid != a.grid else "ns_aux_2d_256"
    if not a.skip_gen:
        folder.mkdir(parents=True, exist_ok=True)
        cfg = make_cfg(a.grid, a.frames, a.frame_int, a.n_batch, "full", a.dt, a.nu,
                       a.diffusion_mode)
        aux_cfg = make_cfg(aux_grid, a.frames, a.frame_int, a.n_batch, "convection",
                           a.dt, a.nu, a.diffusion_mode)
        t0 = time.time()
        fpc = a.frames_per_chunk
        for i in range(a.n_primary):
            f = folder / f"ns_incom_inhom_2d_256-{i}.h5"
            if not f.exists():
                generate_ns_file(f, i, cfg, frames_per_chunk=fpc, device=dev)
                print(f"primary {i}: {time.time()-t0:.0f}s total", flush=True)
        for i in range(n_primary_aux * a.n_aux_per):
            f = folder / f"{aux_name}-{i}.h5"
            if not f.exists():
                generate_ns_file(f, 1000 + i, aux_cfg, frames_per_chunk=fpc, device=dev)
                print(f"aux {i}: {time.time()-t0:.0f}s total", flush=True)
        for i in range(250, 250 + a.n_test):
            f = folder / f"ns_incom_inhom_2d_256-{i}.h5"
            if not f.exists():
                generate_ns_file(f, i, cfg, frames_per_chunk=fpc, device=dev)
        print(f"generation done: {time.time()-t0:.0f}s", flush=True)

    if a.variants == ["none"]:
        return {}

    from sciml_pde_torch.data.ns import load_ns_test
    from sciml_pde_torch.eval.rollout_experiment import rollout_study
    from sciml_pde_torch.models.fno import FNO2d, FNO2dAux
    from sciml_pde_torch.train.fno_train import run_training
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}
    for variant in a.variants:
        t0 = time.time()
        name = f"ns_prod_{variant}{tag}"
        if a.eval_only:
            ck = restore_checkpoint(out / f"{name}_ckpt")
            params, best_val = ck["params"], float(ck["meta"]["loss"])
            print(f"{variant}: restored ckpt best_val={best_val:.6f}", flush=True)
            train_s = 0.0
        else:
            batch = a.batch_size or (8 if variant == "aux" else 16)
            res = run_training(
                base_path=str(folder), aux_path=str(folder), dataset_family="ns",
                if_aux=(variant == "aux"), aux_name=aux_name,
                # 'lie' = the baseline FNO with in-step Lie-Trotter augmentation
                lie_augment=(variant == "lie"),
                train_subsample=(a.n_primary, n_primary_aux, n_primary_aux * a.n_aux_per),
                num_aux_samples=a.n_aux_per, test_range=(250, 250 + a.n_test),
                num_channels=3, modes=12, width=20, initial_step=10,
                batch_size=batch, epochs=a.epochs, host_stream=a.host_stream,
                aux_store_dtype=(None if a.aux_store_dtype == "f32" else a.aux_store_dtype),
                primary_store_dtype=(None if a.primary_store_dtype == "f32"
                                     else a.primary_store_dtype),
                aux_chunks=a.aux_chunks,
                aux_upsample_at_gather=(aux_grid != a.grid),
                aux_native_compute=(a.aux_compute == "native"),
                fno_remat=a.remat, continue_training=a.continue_training,
                resident_rotate=a.resident_rotate,
                resident_rotate_schedule=a.rotate_schedule,
                run_dir=str(out), model_name=name, log_every=500, device=dev,
            )
            params, best_val = res.params, res.best_val
            train_s = time.time() - t0
            print(f"{variant}: best_val={best_val:.6f} in {train_s:.0f}s", flush=True)

        test = load_ns_test(str(folder), initial_step=10, rollout_test=5,
                            test_range=(250, 250 + a.n_test), device=dev)
        model = (FNO2dAux if variant == "aux" else FNO2d)(3, 12, 12, width=20, initial_step=10)
        model.load_state_dict(flax_to_state_dict(params))
        model = model.to(dev).eval()

        def apply_fn(x, g):
            return model(x, g, x, g)[0] if variant == "aux" else model(x, g)

        study = rollout_study(apply_fn, None, test, horizons=(1, 2, 3, 4, 5), batch_size=4,
                              out_path=out / f"rollout_{variant}{tag}.json", device=dev)
        results[variant + tag] = {
            "best_val": float(best_val),
            "train_seconds": train_s,
            "rollout_nrmse": [study[k]["nRMSE"] for k in sorted(study)],
            # rotation departs from the reference's global shuffle (each
            # slice trains in its own epochs): rotated rows are not directly
            # comparable to the others
            "resident_rotate": int(a.resident_rotate),
            "resident_rotate_schedule": a.rotate_schedule if a.resident_rotate else None,
        }
        summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
