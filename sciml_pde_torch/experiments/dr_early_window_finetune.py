"""Early-window fine-tune diagnostic for the DR transformer v-channel gap
(port of the JAX package's ``experiments/dr_early_window_finetune.py``).

Hypothesis 3 of the v-channel investigation (see ``dr_vchannel_diag.py``):
t0 = 0-like windows, where the inhibitor channel is near zero and its
per-(sample, channel) input normalisation is ill-conditioned, are only
~1/91st of the training distribution, so the regime is under-trained.

This script restores the trained baseline checkpoint (``dr_transformer``'s
``vmae_dr_{key}_ckpt``), fine-tunes for a few epochs on windows with
t0 <= --t0-max only (the reference objective: sqrt joint-channel nRMSE +
0.1 relative FFT; optax's ``chain(clip_by_global_norm(1.0),
adamw(cosine_decay_schedule(lr, steps), weight_decay=0.05))``), and
measures the per-channel rollout at t0 = 0 and 20 before and after.
Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch.experiments import _dr_vmae
from sciml_pde_torch.experiments._dr_vmae import per_channel_nrmse


def window_index(n_train: int, t0_max: int) -> np.ndarray:
    """(trajectory, t0) of every early window, trajectory-major."""
    return np.asarray([(n, t0) for n in range(n_train) for t0 in range(t0_max + 1)])


def finetune(model, train: torch.Tensor, idx: np.ndarray, epochs: int, batch_size: int,
             lr: float, log=print) -> list[float]:
    """Fine-tune ``model``'s parameters in place on the windows ``idx`` of
    ``train`` (N, T, H, W, C), in the order of ``np.random.default_rng(0)``'s
    permutations (one an epoch, full batches only).  Returns each step's
    loss."""
    from sciml_pde_torch.train.optim import AdamW, make_lr_schedule
    from sciml_pde_torch.train.transformer_train import fft_relative_l2, transformer_nrmse_sqrt

    params = dict(model.named_parameters())
    steps_total = max(epochs * (len(idx) // batch_size), 1)
    opt = AdamW(params, make_lr_schedule("cosine", lr, steps_total), weight_decay=0.05,
                clip=1.0)
    ar = torch.arange(10, device=train.device)
    rng, losses = np.random.default_rng(0), []
    for ep in range(epochs):
        order = rng.permutation(len(idx))
        ep_losses = []
        for b in range(0, len(idx) - batch_size + 1, batch_size):
            rows = torch.as_tensor(idx[order[b:b + batch_size]], device=train.device)
            x = train[rows[:, 0, None], rows[:, 1, None] + ar[None]]
            y = train[rows[:, 0], rows[:, 1] + 10]
            with torch.enable_grad():
                pred = model(x)
                loss = transformer_nrmse_sqrt(pred, y) + 0.1 * fft_relative_l2(pred, y)
                grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(params, dict(zip(params, grads)))
            ep_losses.append(float(loss.detach()))
        losses += ep_losses
        log(f"epoch {ep}: loss={np.mean(ep_losses):.5f}")
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data/")
    p.add_argument("--ckpt",
                   default="runs/dr_transformer_r2/vmae_dr_basic_ds8_baseline_ckpt")
    _dr_vmae.add_width_args(p)
    p.add_argument("--n-train", type=int, default=8)
    p.add_argument("--t0-max", type=int, default=12)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--rollout", type=int, default=3)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--out", default="runs/dr_transformer_r2/early_finetune.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from sciml_pde_torch._device import resolve_device
    from sciml_pde_torch.data.dr import PRIMARY_FILE, _load_train_pool
    from sciml_pde_torch.utils.checkpoint import restore_params

    dev = resolve_device(a.device)
    train, test, _ = _load_train_pool(Path(a.data), PRIMARY_FILE, a.n_train, None)
    train = torch.as_tensor(np.asarray(train), device=dev)  # (N, T, H, W, C)
    test = np.asarray(test)
    params, best_val = restore_params(Path(a.ckpt))
    print(f"ckpt best_val={best_val:.6f} train={tuple(train.shape)}", flush=True)
    model = _dr_vmae.build(a, _dr_vmae.dtype_of(a.precision), params, dev)

    def eval_t0(t0):
        preds = _dr_vmae.roll(model, torch.as_tensor(test[:, t0:t0 + 10], device=dev),
                              a.rollout)
        return {f"r{k+1}": [float(v) for v in per_channel_nrmse(
                    preds[k], torch.as_tensor(test[:, t0 + 10 + k], device=dev))]
                for k in range(a.rollout)}

    before = {f"t0={t0}": eval_t0(t0) for t0 in (0, 20)}
    print("before:", json.dumps(before), flush=True)
    finetune(model, train, window_index(train.shape[0], a.t0_max), a.epochs, a.batch_size,
             a.lr, log=lambda s: print(s, flush=True))
    after = {f"t0={t0}": eval_t0(t0) for t0 in (0, 20)}
    print("after:", json.dumps(after), flush=True)
    results = {"before": before, "after": after, "config": vars(a)}
    Path(a.out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
