"""FNO-2D baseline trainer on the fused step (port of the fused branch of
``sciml_pde_tpu/train/fno_train.py::run_training``).

``run_training`` loads the DR store from its HDF5 file and calls
``train_baseline``; a caller that already holds the trajectory store in
memory enters at ``train_baseline`` with a ``DRBaselineDataset``.

Per epoch: shuffled window batches -> fused step each -> validation loss
through the fused forward -> best-validation checkpoint (flax-layout
parameter tree, so evaluation and cross-package tools read the layout the
JAX package writes).  Only the plain 2D baseline single-step configuration
runs on the fused step; the others raise, as the JAX package's fused
route does.  Not ported yet: the evaluation path (``if_training=False``),
aux, NS / 3D, autoregressive training.
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
from sciml_pde_torch.data.dr import DRBaselineDataset, load_dr_baseline
from sciml_pde_torch.data.windows import epoch_batches
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.ops.fno_fused_step import fno2d_fused_apply
from sciml_pde_torch.train import fast_step as fs
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.weights import state_dict_to_flax, tree_map

_CKPT_MIN_INTERVAL_S = 60.0


@dataclasses.dataclass
class FNOTrainResult:
    params: Any  # flax-layout FNO2d tree of numpy arrays
    best_val: float
    history: list[dict]


def check_fused_config(*, if_aux=False, model_family="fno", dataset_family="dr",
                       training_type="single", rollout_test=1, lie_augment=False,
                       shard_store=False, host_stream=False, resident_rotate=0,
                       scheduler="cosine", if_training=True) -> None:
    """Raise for a configuration the fused baseline step does not run."""
    ok = (
        not if_aux and model_family == "fno" and dataset_family == "dr"
        and training_type == "single" and rollout_test == 1
        and not lie_augment and not shard_store and not host_stream
        and int(resident_rotate or 0) <= 1 and scheduler == "cosine"
    )
    if not ok:
        raise ValueError(
            "the fused_step trainer runs only the plain 2D FNO baseline on DR "
            "(no aux/3D/NS/autoregressive/lie/shard/stream/rotation, "
            "rollout_test=1, cosine schedule)"
        )
    if not if_training:
        raise ValueError("the evaluation path (if_training=False) is not ported yet")


def default_init_tree(num_channels: int, modes: int, width: int, initial_step: int,
                      seed: int) -> dict:
    """Flax-layout tree of a freshly initialised port ``FNO2d``."""
    model = FNO2d(num_channels, modes, modes, width, initial_step,
                  generator=torch.Generator().manual_seed(seed))
    return state_dict_to_flax(model.state_dict())


def _val_loss(theta, spec, test, modes, initial_step, batch_size) -> float:
    p = fs.unflatten_params(theta, spec)
    grid2 = test.grid.permute(2, 0, 1).contiguous()
    idx_all = torch.as_tensor(test.window_index(), dtype=torch.long, device=theta.device)
    total, nb = 0.0, 0
    with torch.no_grad():
        for b in range(0, len(idx_all), batch_size):
            x, y = fs.fast_gather(test.data, idx_all[b:b + batch_size], initial_step)
            total += float(fs.nrmse_loss_cf(fno2d_fused_apply(x, grid2, p, modes, modes), y))
            nb += 1
    return total / max(nb, 1)


def train_baseline(
    dataset: DRBaselineDataset,
    *,
    modes: int = 12,
    width: int = 20,
    initial_step: int = 10,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate: float = 1e-3,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    continue_training: bool = False,
    log_every: int = 50,
    init_params: dict | None = None,
    device=None,
) -> FNOTrainResult:
    """Train the baseline FNO-2D on an in-memory DR store with the fused step.

    ``init_params`` (flax-layout tree) replaces the seeded initialisation,
    so a run can start from the same weights as a JAX run.  Batches come
    from ``numpy.random.default_rng(seed)``, as in the JAX trainer.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    train_w, test_w = dataset.train, dataset.test
    if train_w.data.ndim != 5:
        raise ValueError("the fused step runs only the 2D FNO (store (N, T, X, Y, C))")
    train_idx = train_w.window_index()
    steps_per_epoch = max(len(train_idx) // batch_size, 1)
    total_steps = epochs * steps_per_epoch

    tree = init_params if init_params is not None else default_init_tree(
        num_channels, modes, width, initial_step, seed)
    theta, spec = fs.fast_state_from_tree(tree, modes, dev)
    opt = fs.init_opt(theta)
    step = fs.build_fast_baseline_step(modes, initial_step, spec, learning_rate, total_steps)
    grid2 = train_w.grid.permute(2, 0, 1).contiguous()

    ckpt_path = Path(run_dir) / f"{model_name}_ckpt.pt"
    best_val, start_epoch = math.inf, 0
    if continue_training and ckpt_path.exists():
        ck = restore_checkpoint(ckpt_path)
        theta, _ = fs.fast_state_from_tree(ck["params"], modes, dev)
        o = ck["opt_state"]
        opt = fs.FlatOptState(o["m"].to(dev), o["v"].to(dev), int(o["count"]))
        start_epoch, best_val = int(ck["meta"]["epoch"]), float(ck["meta"]["loss"])

    def save(state, ep, val):
        th, op = state
        params = fs.tree_from_fast_state(th, spec, modes)
        save_checkpoint(ckpt_path, params, {"m": op.m, "v": op.v, "count": op.count}, ep, val)

    history: list[dict] = []
    gstep, best_state, dirty, last_ckpt_t = 0, None, False, 0.0
    for ep in range(start_epoch, epochs):
        loss_acc, first_loss, nb = None, None, 0
        for bidx in epoch_batches(train_idx, batch_size, rng):
            idx = torch.as_tensor(bidx, dtype=torch.long, device=dev)
            theta, opt, loss, g_norm = step(theta, opt, train_w.data, grid2, idx)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            first_loss = loss if first_loss is None else first_loss
            nb += 1
        gstep += nb
        if log_every and (gstep // log_every) != ((gstep - nb) // log_every):
            print(f"step={gstep} epoch={ep} train_loss={float(loss):.6g} "
                  f"grad_norm={float(g_norm):.6g}", flush=True)
        train_loss = float(loss_acc) / max(nb, 1) if loss_acc is not None else 0.0
        if ep % model_update == 0:
            val = _val_loss(theta, spec, test_w, modes, initial_step, batch_size)
            history.append({"epoch": ep, "train_loss": train_loss, "val_loss": val,
                            "first_step_loss": float(first_loss),
                            "last_step_loss": float(loss)})
            if log_every:
                print(f"step={gstep} epoch={ep} val_loss={val:.6g}", flush=True)
            if val < best_val:
                best_val = val
                best_state = ((theta.clone(), fs.FlatOptState(opt.m.clone(), opt.v.clone(),
                                                              opt.count)), ep)
                if time.time() - last_ckpt_t > _CKPT_MIN_INTERVAL_S:
                    save(best_state[0], ep, best_val)
                    last_ckpt_t, dirty = time.time(), False
                else:
                    dirty = True
    if dirty and best_state is not None:
        save(best_state[0], best_state[1], best_val)
    params = tree_map(lambda t: t.cpu().numpy(), fs.tree_from_fast_state(theta, spec, modes))
    return FNOTrainResult(params=params, best_val=best_val, history=history)


def run_training(
    *,
    base_path: str,
    dataset_family: str = "dr",
    if_aux: bool = False,
    model_family: str = "fno",
    train_subsample=(900, 900, 900),
    modes: int = 12,
    width: int = 20,
    initial_step: int = 10,
    rollout_test: int = 1,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate: float = 1e-3,
    scheduler: str = "cosine",
    training_type: str = "single",
    if_training: bool = True,
    lie_augment: bool = False,
    shard_store: bool = False,
    host_stream: bool = False,
    resident_rotate: int = 0,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    continue_training: bool = False,
    log_every: int = 50,
    init_params: dict | None = None,
    device=None,
) -> FNOTrainResult:
    """Train the DR baseline FNO-2D on the fused step from its HDF5 file
    (``base_path``/2D_diff-react_test_all.h5).  Configurations the fused
    step does not run raise before any data is read."""
    check_fused_config(if_aux=if_aux, model_family=model_family,
                       dataset_family=dataset_family, training_type=training_type,
                       rollout_test=rollout_test, lie_augment=lie_augment,
                       shard_store=shard_store, host_stream=host_stream,
                       resident_rotate=resident_rotate, scheduler=scheduler,
                       if_training=if_training)
    dev = resolve_device(device)
    sub = train_subsample[0] if isinstance(train_subsample, (list, tuple)) else train_subsample
    ds = load_dr_baseline(base_path, train_subsample=sub, initial_step=initial_step,
                          rollout_test=rollout_test, device=dev)
    return train_baseline(
        ds, modes=modes, width=width, initial_step=initial_step, num_channels=num_channels,
        batch_size=batch_size, epochs=epochs, learning_rate=learning_rate,
        model_update=model_update, seed=seed, run_dir=run_dir, model_name=model_name,
        continue_training=continue_training, log_every=log_every,
        init_params=init_params, device=dev,
    )
