"""2D NS transformer (VideoMAE operator) at production shape: baseline vs
aux (port of the JAX package's ``experiments/ns_transformer.py``).

The published-table matrix (Plot Generator/rollout.py:97-99: NS
transformer baseline 0.0479/0.0653/0.0901/0.1183/0.1496, aux
0.0266/0.0467/0.0748/0.1068/0.1423).  The reference recipe
(Transformer_2D_NS/Ours/config_transformer_aux_ns.yaml): img 256, patch
16, tubelet 2, in_chans 3, encoder 768 x 12, decoder 512 x 8, batch 2 x
grad-accum 4, lr 1e-3 cosine, 30 epochs, clip 5.0, fp16 AMP (bf16 here),
aux weight 0.7 with separate per-pixel heads, squared-nRMSE objective.

Data: the family ``experiments/ns_production.py`` writes (256^2 x 1000
frames; primary = full physics, aux = convection only).  Each variant's
best checkpoint is scored at rollout horizons 1..5 (nRMSE) and under the
four published metric conventions into ``summary.json``, with JAX's keys.
``--host-stream`` keeps the train stores in host RAM and streams window
batches to the card; ``--resident-rotate R`` keeps one 1/R slice on the
card at a time.  Runs on the card; ``--device cpu`` runs the plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/ns_production")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--img-size", type=int, default=256,
                   help="spatial size of the stored trajectories")
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--encoder-dim", type=int, default=768)
    p.add_argument("--encoder-depth", type=int, default=12)
    p.add_argument("--encoder-heads", type=int, default=12)
    p.add_argument("--decoder-dim", type=int, default=512)
    p.add_argument("--decoder-depth", type=int, default=8)
    p.add_argument("--decoder-heads", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--aux-weight", type=float, default=0.7)
    p.add_argument("--num-aux-samples", type=int, default=3)
    p.add_argument("--aux-grid", type=int, default=0,
                   help="resolution of the stored aux files (0 = --img-size); a "
                        "lower-resolution store (ns_aux_2d_{grid}-*.h5 from "
                        "ns_production --aux-grid) is upsampled to the primary "
                        "grid inside the step")
    p.add_argument("--n-primary-files", type=int, default=1)
    p.add_argument("--n-test", type=int, default=1)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--loss", choices=["nrmse2", "nrmse"], default="nrmse2",
                   help="the reference NS trainers optimize squared nRMSE")
    p.add_argument("--clip", type=float, default=5.0)
    p.add_argument("--warmup-frac", type=float, default=0.0)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--host-stream", action="store_true",
                   help="stream window batches from host RAM")
    p.add_argument("--aux-store-dtype", default="bf16", choices=["bf16", "f32"],
                   help="dtype of the aux trajectory store")
    p.add_argument("--primary-store-dtype", default="f32", choices=["bf16", "f32"],
                   help="dtype of the primary TRAIN store (aux variant)")
    p.add_argument("--resident-rotate", type=int, default=0,
                   help="R>1: full pool in host RAM, a 1/R trajectory slice on "
                        "the card, rotated between epochs (epochs are per slice: "
                        "R*N epochs = N full passes)")
    p.add_argument("--seed", type=int, default=16)
    p.add_argument("--tag", default="")
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--out", default="runs/ns_transformer")
    p.add_argument("--variants", nargs="+", default=["baseline", "aux"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.data.ns import load_ns_test
    from sciml_pde_torch.eval.rollout import convention_table, evaluate_rollout
    from sciml_pde_torch.models.transformer import VideoMAEOperator, VideoMAEOperatorAux
    from sciml_pde_torch.train.transformer_train import run_transformer_training
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.weights import transformer_flax_to_state_dict

    dev = resolve_device(a.device)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    # the production files hold 2 trajectories x 990 windows each
    steps_per_epoch = max(a.n_primary_files * 2 * 990 // a.batch_size // max(a.grad_accum, 1), 1)
    kw = dict(
        img_size=a.img_size, patch_size=a.patch_size, tubelet_size=2, in_chans=3,
        encoder_embed_dim=a.encoder_dim, encoder_depth=a.encoder_depth,
        encoder_num_heads=a.encoder_heads, decoder_embed_dim=a.decoder_dim,
        decoder_depth=a.decoder_depth, decoder_num_heads=a.decoder_heads,
        initial_step=10, batch_size=a.batch_size, epochs=a.epochs, grad_accum=a.grad_accum,
        bf16=(a.precision == "bf16"), drop_path_rate=a.drop_path,
        learning_rate_share=a.lr, learning_rate_heads=a.lr,
        warmup_steps=int(a.warmup_frac * a.epochs * steps_per_epoch),
        auxiliary_weight=a.aux_weight, seed=a.seed, continue_training=a.continue_training,
        loss_type=a.loss, clip=a.clip, use_checkpoint=a.remat,
        test_range=(250, 250 + a.n_test), host_stream=a.host_stream,
        resident_rotate=a.resident_rotate, device=dev,
    )
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}
    for variant in a.variants:
        key = f"ns_{variant}{('_' + a.tag) if a.tag else ''}"
        ckpt = out / f"vmae_{key}_ckpt"
        t0 = time.time()
        res = None
        if a.eval_only:
            train_s = 0.0
        else:
            aux_grid = a.aux_grid or a.img_size
            store = {} if variant != "aux" else dict(
                aux_store_dtype=None if a.aux_store_dtype == "f32" else a.aux_store_dtype,
                primary_store_dtype=(None if a.primary_store_dtype == "f32"
                                     else a.primary_store_dtype),
                aux_upsample_at_gather=aux_grid != a.img_size)
            res = run_transformer_training(
                base_path=a.data, aux_path=a.data, dataset_family="ns",
                if_aux=(variant == "aux"),
                train_subsample=(a.n_primary_files, a.n_primary_files,
                                 a.n_primary_files * a.num_aux_samples),
                num_aux_samples=a.num_aux_samples, run_dir=str(out),
                aux_name=(f"ns_aux_2d_{aux_grid}" if aux_grid != a.img_size
                          else "ns_aux_2d_256"),
                model_name=f"vmae_{key}", log_every=200, **store, **kw,
            )
            train_s = time.time() - t0
        if ckpt.exists():
            ck = restore_checkpoint(ckpt)
            params, best_val = ck["params"], float(ck["meta"]["loss"])
        else:
            params, best_val = res.params, res.best_val
        print(f"{key}: best_val={best_val:.6f} in {train_s:.0f}s", flush=True)

        test = load_ns_test(a.data, initial_step=10, rollout_test=5,
                            test_range=(250, 250 + a.n_test), device=dev)
        mk = dict(img_size=a.img_size, patch_size=a.patch_size, tubelet_size=2, in_chans=3,
                  num_frames=10, encoder_dim=a.encoder_dim, encoder_depth=a.encoder_depth,
                  encoder_heads=a.encoder_heads, decoder_dim=a.decoder_dim,
                  decoder_depth=a.decoder_depth, decoder_heads=a.decoder_heads,
                  dtype=torch.bfloat16 if a.precision == "bf16" else torch.float32)
        # NS aux keeps separate per-pixel heads
        model = VideoMAEOperatorAux(**mk, shared_head=False) if variant == "aux" \
            else VideoMAEOperator(**mk)
        model.load_state_dict(transformer_flax_to_state_dict(params))
        model = model.to(dev).eval()

        def apply_fn(x, g):
            xt = torch.movedim(x, -2, 1)
            o = model.primary(xt) if variant == "aux" else model(xt)
            return o[..., None, :]

        study = {}
        for k in (1, 2, 3, 4, 5):
            m = evaluate_rollout(apply_fn, test, rollout_test=k, batch_size=2)
            study[k] = m["nRMSE"]
            print(f"rollout {k}: nRMSE={m['nRMSE']:.6f}", flush=True)
        final_seq = [study[k] for k in sorted(study)]
        cum_mean = [float(np.mean(final_seq[: i + 1])) for i in range(len(final_seq))]
        # the four published metric conventions in one pass
        with torch.no_grad():
            conventions = convention_table(apply_fn, test, rollout_test=5, batch_size=2)
        print("joint/all-steps:", " ".join(f"{v:.4f}" for v in conventions["joint_all"]),
              flush=True)
        results[key] = {
            "best_val": float(best_val),
            "train_seconds": train_s,
            "val_history": [h.get("val_loss") for h in res.history] if res else None,
            "rollout_nrmse": final_seq,
            "rollout_nrmse_allsteps": cum_mean,
            "conventions": conventions,
            # rotation departs from the reference's global shuffle
            "resident_rotate": int(a.resident_rotate),
            "resident_rotate_schedule": ("block" if a.resident_rotate else None),
        }
        summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
