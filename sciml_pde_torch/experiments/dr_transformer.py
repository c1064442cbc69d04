"""2D DR transformer (VideoMAE operator): baseline vs aux, any scale (port
of the JAX package's ``experiments/dr_transformer.py``).

The reference's Transformer_2D_DR experiments use in_chans 2, img 128,
tubelet 1, encoder 1024 x 16 heads, 60 epochs, fp16 AMP
(Ours/config_transformer_aux_rd.yaml:39-53).  The defaults here are a
mid-size configuration; the full-size study is driven through the flags:

  python -m sciml_pde_torch.experiments.dr_transformer --dataset basic_ds8 \\
      --epochs 60 --encoder-dim 1024 --encoder-depth 16 --encoder-heads 16 \\
      --decoder-dim 512 --decoder-depth 8 --batch-size 2 --grad-accum 2

Each variant's best-val checkpoint (``{out}/vmae_dr_{key}_ckpt``) is
scored at rollout horizons 1..5 (and the SWA weights where the aux recipe
keeps them) into ``summary.json``, with JAX's keys.  Runs on the card;
``--device cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch.experiments import _dr_vmae


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--dataset", default="basic_ds8")
    p.add_argument("--epochs", type=int, default=30)
    _dr_vmae.add_width_args(p, encoder=(384, 6, 8), decoder=(256, 4, 8))
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--aux-weight", type=float, default=0.5)
    p.add_argument("--warmup-frac", type=float, default=0.05)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--drop-path", type=float, default=0.0,
                   help="reference full-size config uses 0.10")
    p.add_argument("--loss", choices=["nrmse2", "nrmse", "nrmse_perchannel"], default="nrmse",
                   help="the reference DR trainers use true nRMSE (sqrt)")
    p.add_argument("--fourier-weight", type=float, default=0.1,
                   help="relative-FFT-L2 loss weight (published DR recipe: 0.1)")
    p.add_argument("--clip", type=float, default=1.0,
                   help="grad-norm clip (published DR rollout recipe: 1.0)")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder blocks in the backward pass")
    p.add_argument("--seed", type=int, default=16)
    p.add_argument("--tag", default="", help="suffix for model_name/summary keys")
    p.add_argument("--continue-training", action="store_true",
                   help="resume from the run_dir checkpoint")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; restore the best-val checkpoint and run the "
                        "rollout study")
    p.add_argument("--out", default="runs/dr_transformer")
    p.add_argument("--variants", nargs="+", default=["baseline", "aux"])
    p.add_argument("--swa-frac", type=float, default=0.1,
                   help="weight-average window as a fraction of epochs "
                        "(reference aux recipe: last 10%%)")
    p.add_argument("--early-boost", type=float, default=0.0,
                   help="over-sample t0<=12 windows with weight 1+boost "
                        "(v-channel coverage fix; 0 = uniform, the reference)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.data.dr import load_dr_test
    from sciml_pde_torch.eval.rollout import evaluate_rollout
    from sciml_pde_torch.train.transformer_train import run_transformer_training
    from sciml_pde_torch.utils.checkpoint import restore_params
    from sciml_pde_torch.utils.config import load_config

    dev = resolve_device(a.device)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    train_subsample = load_config("config_dr", a.dataset)["train_subsample"]
    # reference hyperparameters (config_transformer_aux_rd.yaml): lr 3e-4, 5%
    # warmup, aux weight 0.5; warmup counts optimizer steps (one per
    # accumulated update), so warmup_frac is a true fraction
    steps_per_epoch = max(train_subsample[0] * 91 // a.batch_size // max(a.grad_accum, 1), 1)
    kw = dict(
        img_size=128, patch_size=16, tubelet_size=1, in_chans=2,
        encoder_embed_dim=a.encoder_dim, encoder_depth=a.encoder_depth,
        encoder_num_heads=a.encoder_heads,
        decoder_embed_dim=a.decoder_dim, decoder_depth=a.decoder_depth,
        decoder_num_heads=a.decoder_heads,
        initial_step=10, batch_size=a.batch_size, epochs=a.epochs,
        grad_accum=a.grad_accum, bf16=(a.precision == "bf16"),
        drop_path_rate=a.drop_path,
        learning_rate_share=a.lr, learning_rate_heads=a.lr,
        warmup_steps=max(int(a.warmup_frac * a.epochs * steps_per_epoch), 1),
        auxiliary_weight=a.aux_weight, seed=a.seed, continue_training=a.continue_training,
        loss_type=a.loss, fourier_weight=a.fourier_weight, clip=a.clip,
        use_checkpoint=a.remat, early_window_boost=a.early_boost, device=dev,
    )
    summary_path = out / "summary.json"
    results = json.loads(summary_path.read_text()) if summary_path.exists() else {}
    test = load_dr_test(a.data, initial_step=10, rollout_test=5, device=dev)
    dtype = _dr_vmae.dtype_of(a.precision)
    for variant in a.variants:
        key = f"{a.dataset}_{variant}{('_' + a.tag) if a.tag else ''}"
        ckpt = out / f"vmae_dr_{key}_ckpt"
        t0 = time.time()
        res = None
        if a.eval_only:
            params, best_val = restore_params(ckpt)
            train_s = 0.0
            print(f"{key}: restored ckpt best_val={best_val:.6f}", flush=True)
        else:
            vkw = dict(kw)
            if variant == "aux":
                # reference DR aux (train_transformer_aux_rd.py): shared decoder
                # output (no separate heads), plain nrmse without the fft term,
                # SWA over the last 10% of epochs
                vkw.update(aux_shared_head=True, fourier_weight=0.0, swa_frac=a.swa_frac)
            res = run_transformer_training(
                base_path=a.data, aux_path=a.data, dataset_family="dr",
                if_aux=(variant == "aux"), train_subsample=tuple(train_subsample),
                num_aux_samples=3, run_dir=str(out), model_name=f"vmae_dr_{key}",
                log_every=500, **vkw,
            )
            # score the BEST-val checkpoint, not the final params: aux training
            # can destabilise late, and the cosine end state is then far off it
            params, best_val = (restore_params(ckpt) if ckpt.exists()
                                else (res.params, res.best_val))
            train_s = time.time() - t0
            print(f"{key}: best_val={res.best_val:.6f} in {train_s:.0f}s", flush=True)

        def apply_for(tree):
            model = _dr_vmae.build(a, dtype, tree, dev, aux=variant == "aux")
            fwd = model.primary if variant == "aux" else model
            return lambda x, g: fwd(torch.movedim(x, -2, 1))[..., None, :]

        apply_fn = apply_for(params)
        study = {}
        for k in (1, 2, 3, 4, 5):
            m = evaluate_rollout(apply_fn, test, rollout_test=k, batch_size=5)
            study[k] = m["nRMSE"]
            print(f"rollout {k}: nRMSE={m['nRMSE']:.6f}", flush=True)
        swa_study = None
        if res is not None and res.swa_params is not None:
            swa_fn, swa_study = apply_for(res.swa_params), []
            for k in (1, 2, 3, 4, 5):
                m = evaluate_rollout(swa_fn, test, rollout_test=k, batch_size=5)
                swa_study.append(m["nRMSE"])
                print(f"SWA rollout {k}: nRMSE={m['nRMSE']:.6f}", flush=True)
        # the published transformer tables score the metric over ALL unrolled
        # frames (Baseline_rollout/metrics.py:186-196); autoregressive unrolls
        # are prefix-consistent, so that is the cumulative mean of the
        # final-step-per-horizon numbers
        final_seq = [study[k] for k in sorted(study)]
        cum_mean = [float(np.mean(final_seq[: i + 1])) for i in range(len(final_seq))]
        results[key] = {
            "best_val": float(best_val),
            "train_seconds": train_s,
            "val_history": [h.get("val_loss") for h in res.history] if res else None,
            "rollout_nrmse": final_seq,
            "rollout_nrmse_allsteps": cum_mean,
            "swa_rollout_nrmse": swa_study,
        }
        summary_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
