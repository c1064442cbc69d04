"""VideoMAE transformer operator trainer, baseline (port of the baseline
branch of ``sciml_pde_tpu/train/transformer_train.py``).

``run_transformer_training`` loads the NS (or DR) store from its HDF5 files
and calls ``train_transformer_baseline``; a caller that already holds the
stores in memory enters there with a dataset (``.train`` and ``.test``
``WindowedTrajectories``).

Per epoch the shuffled batch indices go to the device in one copy.  Per
micro-batch: window gather on the device -> ``VideoMAEOperator`` (its
attention through the CUDA flash-attention kernels on the card) -> loss ->
backward -> the optax chain of ``make_transformer_optimizer`` (gradient
accumulation, global-norm clip, L2 + Adam per parameter group, warmup and
cosine or step schedule).  As in the JAX step, the model runs without
``deterministic=False``, so drop-path never fires in training.  Per epoch:
validation loss and a best-validation checkpoint of the flax-layout tree.
``utils/logging.py::MetricLogger`` writes ``{run_dir}/{model_name}.jsonl``
(and echoes it): the training scalars when ``log_every`` crosses, the
validation loss on every validated epoch.

Not ported yet, and raising: ``if_aux``, ``host_stream``,
``resident_rotate``, ``early_window_boost``, ``swa_frac`` and
``pretrained_path``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.windows import epoch_batches, gather_windows
from sciml_pde_torch.models.transformer import VideoMAEOperator
from sciml_pde_torch.train.optim import (
    GroupedAdamMultiSteps,
    global_norm,
    make_lr_schedule,
    with_warmup,
)
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)

_CKPT_MIN_INTERVAL_S = 120.0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def transformer_nrmse(pred, tgt):
    """Per-sample nRMSE^2 over all non-batch dims, mean-reduced."""
    dims = tuple(range(1, pred.ndim))
    tgt_norm = torch.mean(tgt**2, dim=dims, keepdim=True) + 1e-7
    return torch.mean(torch.mean((pred - tgt) ** 2, dim=dims, keepdim=True) / tgt_norm)


def transformer_nrmse_sqrt(pred, tgt):
    """Per-sample true nRMSE (the DR trainers' objective), mean-reduced."""
    dims = tuple(range(1, pred.ndim))
    mse = torch.mean((pred - tgt) ** 2, dim=dims)
    denom = torch.mean(tgt**2, dim=dims) + 1e-7
    return torch.mean(torch.sqrt(mse) / torch.sqrt(denom))


def transformer_nrmse_perchannel(pred, tgt):
    """Per-(sample, channel) true nRMSE, mean-reduced (channels last)."""
    dims = tuple(range(1, pred.ndim - 1))
    mse = torch.mean((pred - tgt) ** 2, dim=dims)
    denom = torch.mean(tgt**2, dim=dims) + 1e-7
    return torch.mean(torch.sqrt(mse / denom))


def fft_relative_l2(pred, tgt, eps: float = 1e-20):
    """Per-sample relative L2 of the f32 spectra over all non-batch dims,
    mean-reduced."""
    dims = tuple(range(1, pred.ndim))
    pf = torch.fft.fftn(pred.float(), dim=dims)
    tf = torch.fft.fftn(tgt.float(), dim=dims)
    num = torch.sqrt(torch.sum(torch.abs(pf - tf) ** 2, dim=dims))
    den = eps + torch.sqrt(torch.sum(torch.abs(tf) ** 2, dim=dims))
    return torch.mean(num / den)


_LOSSES = {
    "nrmse2": transformer_nrmse,
    "nrmse": transformer_nrmse_sqrt,
    "nrmse_perchannel": transformer_nrmse_perchannel,
}


def _make_loss(loss_type: str, fourier_weight: float):
    """Pixel loss, plus ``fourier_weight`` times the relative FFT L2."""
    base = _LOSSES[loss_type]
    if fourier_weight == 0.0:
        return base

    def loss(pred, tgt):
        return base(pred, tgt) + fourier_weight * fft_relative_l2(pred, tgt)

    return loss


# ---------------------------------------------------------------------------
# optimizer and step
# ---------------------------------------------------------------------------


def _head_group(name: str) -> str:
    top = name.split(".")[0]
    return "heads" if top.startswith(("head_primary", "head_auxiliary")) else "backbone"


def make_transformer_optimizer(
    params: dict[str, torch.Tensor],
    lr_share: float,
    lr_heads: float,
    total_steps: int,
    scheduler: str = "cosine",
    clip: float = 5.0,
    weight_decay: float = 1e-4,
    warmup_steps: int = 0,
    grad_accum: int = 1,
    scheduler_step: int = 100,
    scheduler_gamma: float = 0.5,
) -> GroupedAdamMultiSteps:
    """Two groups, ``backbone`` at ``lr_share`` and the aux heads at
    ``lr_heads``, each schedule over ``total_steps - warmup_steps`` after a
    linear warmup."""
    def sched_for(lr):
        base = make_lr_schedule(scheduler, lr, max(total_steps - warmup_steps, 1),
                                scheduler_step, scheduler_gamma)
        return with_warmup(base, lr, warmup_steps)

    groups: dict[str, list[str]] = {"backbone": [], "heads": []}
    for name in params:
        groups[_head_group(name)].append(name)
    return GroupedAdamMultiSteps(
        params, groups, {"backbone": sched_for(lr_share), "heads": sched_for(lr_heads)},
        clip, weight_decay, grad_accum)


def _to_tf_layout(x):
    """(B, X, Y, T, C) window -> (B, T, H, W, C)."""
    return torch.movedim(x, -2, 1)


def build_transformer_baseline_step(model, opt: GroupedAdamMultiSteps, initial_step: int,
                                    loss_type: str = "nrmse2", fourier_weight: float = 0.0):
    """Returns ``step(data, idx) -> (loss, g_norm)``, one micro-batch that
    updates the model's parameters in place on every ``grad_accum``-th call,
    and ``val(data, idx) -> loss``."""
    loss_fn = _make_loss(loss_type, fourier_weight)
    params = dict(model.named_parameters())

    def step(data, idx):
        x, y = gather_windows(data, idx, initial_step, 1)
        loss = loss_fn(model(_to_tf_layout(x)), y[..., 0, :])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        g_norm = global_norm(list(grads.values()))
        opt.step(params, grads)
        return loss.detach(), g_norm

    @torch.no_grad()
    def val(data, idx):
        x, y = gather_windows(data, idx, initial_step, 1)
        return loss_fn(model(_to_tf_layout(x)), y[..., 0, :])

    return step, val


@dataclasses.dataclass
class TransformerTrainResult:
    params: Any  # flax-layout VideoMAEOperator tree of numpy arrays
    best_val: float
    history: list[dict]


def train_transformer_baseline(
    dataset,
    *,
    img_size: int = 256,
    patch_size: int = 16,
    tubelet_size: int = 2,
    in_chans: int = 3,
    encoder_embed_dim: int = 768,
    encoder_depth: int = 12,
    encoder_num_heads: int = 12,
    decoder_embed_dim: int = 512,
    decoder_depth: int = 8,
    decoder_num_heads: int = 8,
    drop_path_rate: float = 0.0,
    use_checkpoint: bool = False,
    bf16: bool = True,
    initial_step: int = 10,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate_share: float = 1e-3,
    learning_rate_heads: float = 1e-3,
    scheduler: str = "cosine",
    grad_accum: int = 1,
    clip: float = 5.0,
    warmup_steps: int = 0,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/transformer",
    model_name: str = "vmae_ns",
    continue_training: bool = False,
    log_every: int = 50,
    loss_type: str = "nrmse2",
    fourier_weight: float = 0.0,
    init_params: dict | None = None,
    device=None,
) -> TransformerTrainResult:
    """Train the baseline ``VideoMAEOperator`` on in-memory stores.

    ``init_params`` (flax-layout tree) replaces the seeded initialisation,
    so a run can start from the same weights as a JAX run.  Batches come
    from ``numpy.random.default_rng(seed)``, as in the JAX trainer."""
    dev = resolve_device(device)
    logger = MetricLogger(run_dir, name=model_name, echo_every=1)
    rng = np.random.default_rng(seed)
    train_w, test_w = dataset.train, dataset.test
    train_idx, test_idx = train_w.window_index(), test_w.window_index()
    steps_per_epoch = max(len(train_idx) // batch_size, 1)
    total_steps = epochs * steps_per_epoch // max(grad_accum, 1)

    model = VideoMAEOperator(
        img_size=img_size, patch_size=patch_size, tubelet_size=tubelet_size,
        in_chans=in_chans, num_frames=initial_step, encoder_dim=encoder_embed_dim,
        encoder_depth=encoder_depth, encoder_heads=encoder_num_heads,
        decoder_dim=decoder_embed_dim, decoder_depth=decoder_depth,
        decoder_heads=decoder_num_heads, drop_path_rate=drop_path_rate,
        use_checkpoint=use_checkpoint, dtype=torch.bfloat16 if bf16 else torch.float32,
        generator=torch.Generator().manual_seed(seed),
    )
    if init_params is not None:
        model.load_state_dict(transformer_flax_to_state_dict(init_params))
    model.to(dev)
    params = dict(model.named_parameters())
    opt = make_transformer_optimizer(params, learning_rate_share, learning_rate_heads,
                                     total_steps, scheduler, clip=clip,
                                     warmup_steps=warmup_steps, grad_accum=grad_accum)
    step, val = build_transformer_baseline_step(model, opt, initial_step, loss_type,
                                                fourier_weight)

    ckpt_path = Path(run_dir) / f"{model_name}_ckpt.pt"
    best_val, start_epoch = math.inf, 0
    if continue_training and ckpt_path.exists():
        ck = restore_checkpoint(ckpt_path)
        model.load_state_dict(transformer_flax_to_state_dict(ck["params"]))
        opt.load_state_dict(ck["opt_state"])
        start_epoch, best_val = int(ck["meta"]["epoch"]), float(ck["meta"]["loss"])

    def snapshot():
        return ({n: p.detach().clone() for n, p in params.items()},
                {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                 for k, v in opt.state_dict().items()})

    def save(state, ep, val_loss):
        save_checkpoint(ckpt_path, transformer_state_dict_to_flax(state[0]), state[1], ep,
                        val_loss)

    history: list[dict] = []
    gstep, best_state, dirty, last_ckpt_t = 0, None, False, 0.0
    for ep in range(start_epoch, epochs):
        # the epoch's batches go to the device in one copy, as in the JAX
        # trainer: a copy from host memory waits for the card's queue
        batches = torch.as_tensor(np.stack(list(epoch_batches(train_idx, batch_size, rng))),
                                  dtype=torch.long, device=dev)
        loss_acc, first_loss, nb = None, None, 0
        for idx in batches:
            loss, g_norm = step(train_w.data, idx)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            first_loss = loss if first_loss is None else first_loss
            nb += 1
        gstep += nb
        if log_every and (gstep // log_every) != ((gstep - nb) // log_every):
            logger.log(gstep, train_loss=float(loss), grad_norm=float(g_norm), epoch=ep)
        train_loss = float(loss_acc) / max(nb, 1)
        if ep % model_update == 0:
            val_sum, vb = 0.0, 0
            for b in range(0, len(test_idx), batch_size):
                chunk = torch.as_tensor(test_idx[b:b + batch_size], dtype=torch.long, device=dev)
                val_sum += float(val(test_w.data, chunk))
                vb += 1
            val_loss = val_sum / max(vb, 1)
            history.append({"epoch": ep, "train_loss": train_loss, "val_loss": val_loss,
                            "first_step_loss": float(first_loss), "last_step_loss": float(loss)})
            logger.log(gstep, epoch=ep, val_loss=val_loss)
            if val_loss < best_val:
                best_val, best_state = val_loss, (snapshot(), ep)
                if time.time() - last_ckpt_t > _CKPT_MIN_INTERVAL_S:
                    save(best_state[0], ep, best_val)
                    last_ckpt_t, dirty = time.time(), False
                else:
                    dirty = True
    if dirty and best_state is not None:
        save(best_state[0], best_state[1], best_val)
    return TransformerTrainResult(params=transformer_state_dict_to_flax(params),
                                  best_val=best_val, history=history)


def run_transformer_training(
    *,
    base_path: str,
    dataset_family: str = "ns",
    if_aux: bool = True,
    sim_name: str = "ns_incom_inhom_2d_256",
    test_range=(250, 275),
    train_subsample=(900, 900, 900),
    img_size: int = 256,
    patch_size: int = 16,
    tubelet_size: int = 2,
    in_chans: int = 3,
    encoder_embed_dim: int = 768,
    encoder_depth: int = 12,
    encoder_num_heads: int = 12,
    decoder_embed_dim: int = 512,
    decoder_depth: int = 8,
    decoder_num_heads: int = 8,
    drop_path_rate: float = 0.0,
    use_checkpoint: bool = False,
    bf16: bool = True,
    initial_step: int = 10,
    rollout_test: int = 1,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate_share: float = 1e-3,
    learning_rate_heads: float = 1e-3,
    scheduler: str = "cosine",
    grad_accum: int = 1,
    clip: float = 5.0,
    warmup_steps: int = 0,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/transformer",
    model_name: str = "vmae_ns",
    continue_training: bool = False,
    pretrained_path: str | None = None,
    log_every: int = 50,
    loss_type: str = "nrmse2",
    fourier_weight: float = 0.0,
    swa_frac: float = 0.0,
    early_window_boost: float = 0.0,
    host_stream: bool = False,
    resident_rotate: int = 0,
    init_params: dict | None = None,
    device=None,
) -> TransformerTrainResult:
    """Train the baseline transformer from the NS files
    (``{sim_name}-{i}.h5``) or the DR file under ``base_path``.  Options
    not ported yet raise before any data is read."""
    unported = {"if_aux": if_aux, "pretrained_path": pretrained_path, "swa_frac": swa_frac,
                "early_window_boost": early_window_boost, "host_stream": host_stream,
                "resident_rotate": int(resident_rotate or 0) > 1}
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)} (the port trains the baseline, "
            "if_aux=False, from device-resident stores)")
    dev = resolve_device(device)
    sub = train_subsample[0] if isinstance(train_subsample, (list, tuple)) else train_subsample
    if dataset_family == "ns":
        from sciml_pde_torch.data.ns import load_ns_baseline

        ds = load_ns_baseline(base_path, train_subsample=sub, initial_step=initial_step,
                              rollout_test=rollout_test, sim_name=sim_name,
                              test_range=test_range, device=dev)
    elif dataset_family == "dr":
        from sciml_pde_torch.data.dr import load_dr_baseline

        ds = load_dr_baseline(base_path, train_subsample=sub, initial_step=initial_step,
                              rollout_test=rollout_test, device=dev)
    else:
        raise ValueError(f"unknown dataset_family {dataset_family!r}")
    return train_transformer_baseline(
        ds, img_size=img_size, patch_size=patch_size, tubelet_size=tubelet_size,
        in_chans=in_chans, encoder_embed_dim=encoder_embed_dim, encoder_depth=encoder_depth,
        encoder_num_heads=encoder_num_heads, decoder_embed_dim=decoder_embed_dim,
        decoder_depth=decoder_depth, decoder_num_heads=decoder_num_heads,
        drop_path_rate=drop_path_rate, use_checkpoint=use_checkpoint, bf16=bf16,
        initial_step=initial_step, batch_size=batch_size, epochs=epochs,
        learning_rate_share=learning_rate_share, learning_rate_heads=learning_rate_heads,
        scheduler=scheduler, grad_accum=grad_accum, clip=clip, warmup_steps=warmup_steps,
        model_update=model_update, seed=seed, run_dir=run_dir, model_name=model_name,
        continue_training=continue_training, log_every=log_every, loss_type=loss_type,
        fourier_weight=fourier_weight, init_params=init_params, device=dev,
    )
