"""3D NS plume parity: FNO3d baseline vs aux, rollout 1..5 table (port of
the JAX package's ``experiments/plume3d_parity.py``).

Targets the published 3D table (Plot Generator/rollout.py:123-125):
  baseline: 0.067505 / 0.109714 / 0.150054 / 0.185311 / 0.218163
  aux:      0.048125 / 0.086153 / 0.120555 / 0.149356 / 0.174979

Reference configuration (models/config/config_ns_3d.yaml): modes 12,
width 20, initial_step 10, t_train 150, 20 epochs, cosine; aux pairing
``p*num_aux_samples + j`` with convection-form decomposed trajectories;
test seeds 275+.  The data are written by the port's own generator
(``sim/ns_plume_3d.py``) at the production resolution 50x50x89: the
``_interp`` primary seeds, the convection-form aux seeds and the test
seeds from 275.

  python -m sciml_pde_torch.experiments.plume3d_parity --folder data/plume3d_parity

Runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU.  ``--host-stream`` keeps the train stores in host RAM and streams
window batches to the card, as the trainer's ``host_stream`` does.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from sciml_pde_torch.eval.rollout import evaluate_rollout
from sciml_pde_torch.train.fno_train import run_training


def plume_configs(res, frames: int, substeps: int):
    """The primary (full physics) and aux (convection form) generator
    configurations."""
    from sciml_pde_torch.sim.ns_plume_3d import Plume3DConfig

    common = dict(res=tuple(res), n_frames=frames, substeps=substeps, out_res=tuple(res),
                  out_frames=frames)
    return (Plume3DConfig(**common),
            Plume3DConfig(**common, enable_diffusion=False, enable_buoyancy=False))


def generate(folder: Path, cfg, aux_cfg, primary, aux, test, device,
             skip_existing: bool = True) -> int:
    """Write the trajectories (with ``skip_existing``, those missing):
    ``_interp`` primary seeds ``primary``, suffix-less aux seeds ``aux``,
    ``_interp`` test seeds ``test``.  Returns how many were written."""
    from sciml_pde_torch.sim.ns_plume_3d import generate_plume_files

    done = 0
    for seeds, c, suffix in ((primary, cfg, "_interp"), (aux, aux_cfg, ""),
                             (test, cfg, "_interp")):
        for i in seeds:
            if not (skip_existing and (folder / f"v_trj_seed{i}{suffix}.h5").exists()):
                generate_plume_files(folder, i, c, suffix=suffix, device=device)
                done += 1
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folder", default="data/plume3d_parity")
    p.add_argument("--res", type=int, nargs=3, default=[50, 50, 89])
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--substeps", type=int, default=10)
    p.add_argument("--n-primary", type=int, default=8)
    p.add_argument("--n-aux-per", type=int, default=3)
    p.add_argument("--aux-primary", type=int, default=4,
                   help="primary count for the aux variant (ds8 = [8,4,12])")
    p.add_argument("--n-test", type=int, default=4)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--modes", type=int, default=12)
    p.add_argument("--width", type=int, default=20)
    p.add_argument("--initial-step", type=int, default=10)
    p.add_argument("--skip-gen", action="store_true")
    p.add_argument("--host-stream", action="store_true",
                   help="keep the trajectory store in host RAM and stream window "
                        "batches to the card (the trainer's host_stream)")
    p.add_argument("--aux-store-dtype", default="bf16", choices=["bf16", "f32"],
                   help="device dtype of the aux trajectory store")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the 4 spectral blocks on backward")
    p.add_argument("--primary-store-dtype", default="f32", choices=["bf16", "f32"],
                   help="device dtype of the primary trajectory store (compute stays "
                        "f32 from the window gather on)")
    p.add_argument("--aux-weight", type=float, default=0.7, help="aux loss weight")
    p.add_argument("--lr-share", type=float, default=None,
                   help="override shared-backbone LR (aux recipe axis)")
    p.add_argument("--lr-heads", type=float, default=None,
                   help="override head LR (aux recipe axis)")
    p.add_argument("--tag", default="",
                   help="suffix for model_name/summary keys (recipe sweeps)")
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--variants", nargs="+", default=["baseline", "aux"],
                   help="baseline | aux (FNO3d) | tf_baseline | tf_aux "
                        "(3D VideoMAE at the reference size: encoder "
                        "1024x16x32h, decoder 768x8x8h, patch (10,10,9), "
                        "tubelet 5 — config_transformer_aux_ns_3d.yaml:41-54)")
    p.add_argument("--tf-encoder-dim", type=int, default=1024)
    p.add_argument("--tf-encoder-depth", type=int, default=16)
    p.add_argument("--tf-decoder-depth", type=int, default=8)
    p.add_argument("--tf-remat", action="store_true",
                   help="gradient-checkpoint the ViT blocks")
    p.add_argument("--out", default="runs/plume3d_parity")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.data.ns3d import load_ns3d_aux
    from sciml_pde_torch.train.fno_train import _Family
    from sciml_pde_torch.utils.checkpoint import restore_params

    dev = resolve_device(a.device)
    folder = Path(a.folder)
    cfg, aux_cfg = plume_configs(a.res, a.frames, a.substeps)
    n_aux_total = a.aux_primary * a.n_aux_per
    test_range = (275, 275 + a.n_test)
    if not a.skip_gen:
        t0 = time.time()
        done = generate(folder, cfg, aux_cfg, range(a.n_primary), range(n_aux_total),
                        range(*test_range), dev)
        print(f"generation: {done} new trajectories in {time.time()-t0:.0f}s", flush=True)

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}

    # Reference 3D ViT hyperparameters (Transformer_3D_NS/Ours/
    # config_transformer_aux_ns_3d.yaml:41-54)
    tf_kwargs = dict(
        patch_size=(10, 10, 9), tubelet_size=5,
        encoder_dim=a.tf_encoder_dim, encoder_depth=a.tf_encoder_depth,
        encoder_heads=max(a.tf_encoder_dim // 32, 1),
        decoder_dim=768 if a.tf_encoder_dim >= 1024 else a.tf_encoder_dim,
        decoder_depth=a.tf_decoder_depth, decoder_heads=8,
        drop_path_rate=0.15, use_checkpoint=a.tf_remat,
    )
    tag = ("_" + a.tag) if a.tag else ""
    for variant in a.variants:
        if_aux = variant.endswith("aux")
        is_tf = variant.startswith("tf_")
        sub = ((a.n_primary, a.aux_primary, n_aux_total) if if_aux
               else (a.n_primary, a.n_primary, n_aux_total))
        name = f"plume_{variant}{tag}"
        t0 = time.time()
        res = run_training(
            base_path=str(folder), aux_path=str(folder), dataset_family="ns3d",
            if_aux=if_aux, train_subsample=sub,
            num_aux_samples=a.n_aux_per, test_range=test_range,
            num_channels=4, modes=a.modes, width=a.width,
            initial_step=a.initial_step,
            model_family="transformer3d" if is_tf else "fno",
            transformer_kwargs=tf_kwargs if is_tf else None,
            learning_rate=a.lr_share or (1.5e-4 if is_tf else 1e-3),
            learning_rate_share=a.lr_share or (1.5e-4 if is_tf else 1e-3),
            learning_rate_fc2=a.lr_heads or (1.5e-4 if is_tf else 1e-3),
            auxiliary_weight=a.aux_weight,
            rollout_test=1, batch_size=a.batch_size, epochs=a.epochs,
            host_stream=a.host_stream,
            aux_store_dtype=(None if a.aux_store_dtype == "f32" else a.aux_store_dtype),
            primary_store_dtype=(None if a.primary_store_dtype == "f32"
                                 else a.primary_store_dtype),
            fno_remat=a.remat,
            run_dir=str(out), model_name=name, log_every=200,
            continue_training=a.continue_training or a.eval_only,
            if_training=not a.eval_only, device=dev,
        )
        train_s = time.time() - t0
        print(f"{variant}: best_val={res.best_val:.6f} in {train_s:.0f}s", flush=True)

        # rollout study 1..5 on the best-val checkpoint
        ds = load_ns3d_aux(
            str(folder), str(folder),
            train_subsample=(1, 1, max(a.n_aux_per, 1)),
            num_aux_samples=a.n_aux_per, initial_step=a.initial_step,
            rollout_test=5, test_seeds=range(*test_range), with_aux=False, device=dev,
        )
        params, best_val = restore_params(out / f"{name}_ckpt")
        family = _Family("transformer3d" if is_tf else "fno", tf_kwargs if is_tf else None,
                         ds.primary_test, 4, a.modes, a.width, a.initial_step, aux=if_aux)
        model = family.model()
        model.load_state_dict(family.to_sd(params))
        model = model.to(dev).eval()

        def apply_fn(x, g):
            return model(x, g, x, g)[0] if if_aux else model(x, g)

        study = {}
        for k in (1, 2, 3, 4, 5):
            m = evaluate_rollout(apply_fn, ds.primary_test, rollout_test=k, batch_size=1)
            study[k] = m["nRMSE"]
            print(f"rollout {k}: nRMSE={m['nRMSE']:.6f}", flush=True)

        results[variant + tag] = {
            "best_val": best_val,
            "train_seconds": train_s,
            "rollout_nrmse": [study[k] for k in sorted(study)],
            "aux_weight": a.aux_weight,
            "lr_share": a.lr_share, "lr_heads": a.lr_heads,
            "n_aux_per": a.n_aux_per,
        }
        summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
