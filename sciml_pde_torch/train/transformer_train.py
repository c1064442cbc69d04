"""VideoMAE transformer operator trainers, baseline and aux joint training
(port of ``sciml_pde_tpu/train/transformer_train.py``).

``run_transformer_training`` loads the NS (or DR) stores from their HDF5
files and calls ``train_transformer_baseline`` (``if_aux=False``) or
``train_transformer_aux``; a caller that already holds the stores in memory
enters there with a dataset (``.train`` / ``.test``, or ``.primary_train``,
``.primary_test``, ``.aux_train`` and NS's ``.aux_row_map``).

Per epoch the shuffled batch indices go to the device in one copy
(``early_window_boost``: drawn with replacement, windows with t0 <=
``early_window_t0`` weighted 1 + boost).  Per micro-batch: window gather on
the device -> ``VideoMAEOperator`` (its attention through the CUDA
flash-attention kernels on the card) -> loss -> backward -> the optax chain
of ``make_transformer_optimizer`` (gradient accumulation, global-norm clip,
L2 + Adam per parameter group, warmup and cosine or step schedule, and with
``swa_frac`` a constant ``lr * swa_lr_factor`` from the SWA window's first
update).  The aux step gathers each primary window's ``num_aux_samples``
aux windows at the same t0, casts both streams to f32 (an aux store at its
own resolution is upsampled to the primary grid there), runs
``VideoMAEOperatorAux`` on both and takes ``lp + auxiliary_weight * la``.
As in the JAX step, the model runs without ``deterministic=False``, so
drop-path never fires in training.  Per epoch: the running mean of the
weights inside the SWA window, the validation loss (the primary head's, for
aux) and a best-validation checkpoint of the flax-layout tree.
``pretrained_path`` overlays a checkpoint of the port (say, of
``train/ssl_pretrain.py``) where path and shape match.
``utils/logging.py::MetricLogger`` writes ``{run_dir}/{model_name}.jsonl``
(and echoes it): the training scalars when ``log_every`` crosses, the
validation loss on every validated epoch.

``host_stream`` streams window batches gathered in host RAM (the steps'
``xy`` variants), ``resident_rotate`` keeps one slice of the pool on the
device at a time, and over the ranks of a process group the run is data
parallel (``train/placement.py``, ``parallel/``), as in ``fno_train.py``.
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
from sciml_pde_torch.data.dr import resize_linear
from sciml_pde_torch.data.windows import (
    check_aux_pairing,
    epoch_batches,
    gather_windows,
    make_aux_indices,
    weighted_epoch_batches,
)
from sciml_pde_torch.models.transformer import VideoMAEOperator, VideoMAEOperatorAux
from sciml_pde_torch.parallel import (
    data_parallel,
    make_mesh,
    mean_over_ranks,
    replicate,
    shard_batch,
)
from sciml_pde_torch.train.optim import (
    GroupedAdamMultiSteps,
    global_norm,
    make_lr_schedule,
    with_constant_from,
    with_warmup,
)
from sciml_pde_torch.train.placement import (
    InFlight,
    PinnedRing,
    place_stores,
    record_run,
    slice_for,
)
from sciml_pde_torch.utils.checkpoint import (
    load_partial_params,
    restore_checkpoint,
    save_checkpoint,
)
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
# optimizer and steps
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
    swa_start: int | None = None,
    swa_lr_factor: float = 0.1,
) -> GroupedAdamMultiSteps:
    """Two groups, ``backbone`` at ``lr_share`` and the aux heads at
    ``lr_heads``, each schedule over ``total_steps - warmup_steps`` after a
    linear warmup; from update ``swa_start`` on (SWALR) the constant ``lr *
    swa_lr_factor``."""
    def sched_for(lr):
        base = make_lr_schedule(scheduler, lr, max(total_steps - warmup_steps, 1),
                                scheduler_step, scheduler_gamma)
        return with_constant_from(with_warmup(base, lr, warmup_steps), lr * swa_lr_factor,
                                  swa_start)

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
    and ``val(data, idx) -> loss``; ``step.xy(x, y)`` takes the windows
    gathered already (``data/stream.py::HostWindowLoader``)."""
    loss_fn = _make_loss(loss_type, fourier_weight)
    params = dict(model.named_parameters())

    def step_xy(x, y):
        loss = loss_fn(model(_to_tf_layout(x.float())), y.float()[..., 0, :])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        g_norm = global_norm(list(grads.values()))
        opt.step(params, grads)
        return loss.detach(), g_norm

    def step(data, idx):
        return step_xy(*gather_windows(data, idx, initial_step, 1))

    @torch.no_grad()
    def val(data, idx):
        x, y = gather_windows(data, idx, initial_step, 1)
        return loss_fn(model(_to_tf_layout(x)), y[..., 0, :])

    step.xy = step_xy
    return step, val


def build_transformer_aux_step(model, opt: GroupedAdamMultiSteps, initial_step: int,
                               num_aux_samples: int, auxiliary_weight: float,
                               aux_row_map: np.ndarray | None = None, loss_type: str = "nrmse2",
                               fourier_weight: float = 0.0,
                               aux_resize_to: tuple[int, ...] | None = None):
    """Returns ``step(data_p, data_a, idx) -> ((loss, lp, la), g_norm)``, one
    micro-batch of aux joint training that updates the model's parameters
    in place on every ``grad_accum``-th call (``g_norm``: the micro-batch
    gradients' global norm, before the clip), and ``val_primary(data_p,
    idx) -> loss``.

    Pairing: primary trajectory ``p`` with aux rows ``p * num_aux_samples +
    j`` or ``aux_row_map[p, j]``, at the same t0, flattened p-major.  Both
    streams are cast to f32 after the gather (a store may be bf16); with
    ``aux_resize_to`` the aux windows, input and target, are then upsampled
    to that spatial shape (JAX's linear resize).  ``step.xy(x, y, xa, ya)``
    takes the windows gathered already
    (``data/stream.py::AuxHostWindowLoader``)."""
    loss_fn = _make_loss(loss_type, fourier_weight)
    params = dict(model.named_parameters())
    aux_indices = make_aux_indices(num_aux_samples, aux_row_map)

    def to_model_res(a):
        a = a.float()
        if aux_resize_to is not None and tuple(a.shape[1:-2]) != tuple(aux_resize_to):
            a = resize_linear(a, dict(enumerate(aux_resize_to, start=1)))
        return a

    def step_xy(x, y, xa, ya):
        xa, ya = to_model_res(xa), to_model_res(ya)
        pred_p, pred_a = model(_to_tf_layout(x.float()), _to_tf_layout(xa))
        lp = loss_fn(pred_p, y.float()[..., 0, :])
        la = loss_fn(pred_a, ya[..., 0, :])
        loss = lp + auxiliary_weight * la
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        g_norm = global_norm(list(grads.values()))
        opt.step(params, grads)
        return (loss.detach(), lp.detach(), la.detach()), g_norm

    def step(data_p, data_a, idx):
        x, y = gather_windows(data_p, idx, initial_step, 1)
        return step_xy(x, y, *gather_windows(data_a, aux_indices(idx), initial_step, 1))

    @torch.no_grad()
    def val_primary(data_p, idx):
        # JAX scores model(x, x)[0]; the primary output does not depend on
        # the aux stream, so the primary stream runs through the trunk alone
        x, y = gather_windows(data_p, idx, initial_step, 1)
        return loss_fn(model.primary(_to_tf_layout(x.float())), y.float()[..., 0, :])

    step.xy = step_xy
    return step, val_primary


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransformerTrainResult:
    params: Any  # flax-layout VideoMAEOperator(Aux) tree of numpy arrays
    best_val: float
    history: list[dict]
    swa_params: Any = None  # the mean of the SWA window's per-epoch weights (swa_frac > 0)


def train_transformer_baseline(dataset, **kwargs) -> TransformerTrainResult:
    """Train the baseline ``VideoMAEOperator`` on in-memory stores
    (``dataset.train`` / ``dataset.test``); the keywords are ``_train``'s."""
    return _train(dataset, None, **kwargs)


def train_transformer_aux(dataset, *, num_aux_samples: int = 24, auxiliary_weight: float = 0.7,
                          aux_shared_head: bool = False, **kwargs) -> TransformerTrainResult:
    """Aux joint training of ``VideoMAEOperatorAux`` on in-memory stores
    (``dataset.primary_train``, ``.primary_test``, ``.aux_train`` and, for
    NS, ``.aux_row_map``): separate per-pixel heads, or with
    ``aux_shared_head`` the trunk's frame for both streams.  An aux store
    of another spatial resolution is upsampled to the primary grid inside
    the step.  Validation and the checkpoint follow the primary loss.  The
    other keywords are ``_train``'s."""
    return _train(dataset, dict(num_aux_samples=num_aux_samples,
                                auxiliary_weight=auxiliary_weight, shared_head=aux_shared_head),
                  **kwargs)


def _train(
    dataset,
    aux: dict | None,
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
    pretrained_path: str | None = None,
    log_every: int = 50,
    loss_type: str = "nrmse2",
    fourier_weight: float = 0.0,
    swa_frac: float = 0.0,
    swa_lr_factor: float = 0.1,
    early_window_boost: float = 0.0,
    early_window_t0: int = 12,
    init_params: dict | None = None,
    host_stream: bool = False,
    resident_rotate: int = 0,
    resident_rotate_schedule: str = "block",
    device=None,
) -> TransformerTrainResult:
    """The epoch loop of both trainers; ``aux`` holds ``num_aux_samples``,
    ``auxiliary_weight`` and ``shared_head``, or is None for the baseline.

    ``init_params`` (flax-layout tree) replaces the seeded initialisation,
    so a run can start from the same weights as a JAX run.  Batches come
    from ``numpy.random.default_rng(seed)``, as in the JAX trainer (under
    ``host_stream`` from the host loader seeded the same).
    ``host_stream`` and ``resident_rotate`` (``block``, ``interleave``,
    ``cyclic``) place the train stores as ``train/placement.py::
    place_stores`` says; at most ``STREAM_PIPELINE`` micro-steps are in
    flight on the card.  Over the ranks of a process group each rank takes
    its rows of every micro-batch and the accumulation sees the gradients'
    mean over the ranks; rank 0 logs and writes the checkpoints."""
    if int(resident_rotate or 0) > 1 and host_stream:
        raise ValueError("resident_rotate and host_stream are mutually exclusive")
    if host_stream and early_window_boost > 0:
        raise NotImplementedError(
            "early_window_boost with host_stream: the stream loader "
            "controls sampling; use the device-store path for the DR "
            "early-window study"
        )
    dev = resolve_device(device)
    mesh = make_mesh()
    lead = mesh.rank == 0
    logger = MetricLogger(run_dir, name=model_name, echo_every=1) if lead else None
    rng = np.random.default_rng(seed)
    if aux is None:
        train_w, test_w, aux_w, row_map, n_aux = dataset.train, dataset.test, None, None, 0
    else:
        train_w, test_w = dataset.primary_train, dataset.primary_test
        aux_w, row_map = dataset.aux_train, getattr(dataset, "aux_row_map", None)
        n_aux = aux["num_aux_samples"]
        check_aux_pairing(train_w, aux_w, n_aux, row_map)
    place = place_stores(train_w, aux_w, batch_size=batch_size, seed=seed, dev=dev,
                         num_aux=n_aux, row_map=row_map, host_stream=host_stream,
                         resident_rotate=resident_rotate, mesh=mesh)
    train_w, aux_w = place.train_w, place.aux_w
    train_idx, test_idx = place.train_idx, test_w.window_index()
    steps_per_epoch = max(len(train_idx) // batch_size, 1)
    total_steps = epochs * steps_per_epoch // max(grad_accum, 1)
    # the SWA window: the last swa_frac of the epochs, from the update its
    # first epoch starts with
    swa_start_ep = epochs - max(int(epochs * swa_frac), 1) if swa_frac > 0 else None
    swa_start_step = (None if swa_start_ep is None
                      else swa_start_ep * steps_per_epoch // max(grad_accum, 1))

    kwargs = dict(
        img_size=img_size, patch_size=patch_size, tubelet_size=tubelet_size,
        in_chans=in_chans, num_frames=initial_step, encoder_dim=encoder_embed_dim,
        encoder_depth=encoder_depth, encoder_heads=encoder_num_heads,
        decoder_dim=decoder_embed_dim, decoder_depth=decoder_depth,
        decoder_heads=decoder_num_heads, drop_path_rate=drop_path_rate,
        use_checkpoint=use_checkpoint, dtype=torch.bfloat16 if bf16 else torch.float32,
        generator=torch.Generator().manual_seed(seed),
    )
    model = (VideoMAEOperator(**kwargs) if aux is None
             else VideoMAEOperatorAux(**kwargs, shared_head=aux["shared_head"]))
    if init_params is not None:
        model.load_state_dict(transformer_flax_to_state_dict(init_params))
    if pretrained_path:
        tree = load_partial_params(transformer_state_dict_to_flax(model.state_dict()),
                                   restore_checkpoint(pretrained_path)["params"])
        model.load_state_dict(transformer_flax_to_state_dict(tree))
    model.to(dev)
    params = dict(model.named_parameters())
    replicate(list(params.values()), mesh)
    opt = data_parallel(make_transformer_optimizer(
        params, learning_rate_share, learning_rate_heads, total_steps, scheduler, clip=clip,
        warmup_steps=warmup_steps, grad_accum=grad_accum, swa_start=swa_start_step,
        swa_lr_factor=swa_lr_factor), mesh)
    if aux is None:
        step_b, val_b = build_transformer_baseline_step(model, opt, initial_step, loss_type,
                                                        fourier_weight)
        step = lambda idx: step_b(train_w.data, idx)  # noqa: E731
        step_xy = step_b.xy
        val = lambda idx: val_b(test_w.data, idx)  # noqa: E731
    else:
        prim_sp, aux_sp = tuple(train_w.data.shape[2:-1]), tuple(aux_w.data.shape[2:-1])
        step_a, val_a = build_transformer_aux_step(
            model, opt, initial_step, n_aux, aux["auxiliary_weight"], place.row_map,
            loss_type, fourier_weight, aux_resize_to=prim_sp if aux_sp != prim_sp else None)

        def step(idx):
            (loss, _, _), g_norm = step_a(train_w.data, aux_w.data, idx)
            return loss, g_norm

        def step_xy(x, y, xa, ya):
            (loss, _, _), g_norm = step_a.xy(x, y, xa, ya)
            return loss, g_norm
        val = lambda idx: val_a(test_w.data, idx)  # noqa: E731

    ckpt_path = Path(run_dir) / f"{model_name}_ckpt"
    best_val, start_epoch = math.inf, 0
    if continue_training and ckpt_path.exists():
        ck = restore_checkpoint(ckpt_path)
        model.load_state_dict(transformer_flax_to_state_dict(ck["params"]))
        opt.load_state_dict(opt.state_from_optax(ck["opt_state"], transformer_flax_to_state_dict))
        start_epoch, best_val = int(ck["meta"]["epoch"]), float(ck["meta"]["loss"])

    def snapshot():
        return ({n: p.detach().clone() for n, p in params.items()},
                {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                 for k, v in opt.state_dict().items()})

    def save(state, ep, val_loss):
        if lead:
            save_checkpoint(ckpt_path, transformer_state_dict_to_flax(state[0]),
                            opt.optax_tree(state[1], transformer_state_dict_to_flax), ep, val_loss)

    early_w = (1.0 + early_window_boost * (train_idx[:, 1] <= early_window_t0)
               if early_window_boost > 0 else None)
    test_idx_dev = torch.as_tensor(test_idx, dtype=torch.long, device=dev)
    history: list[dict] = []
    gstep, best_state, dirty, last_ckpt_t = 0, None, False, 0.0
    swa, swa_n = None, 0
    ring, inflight = PinnedRing(dev), InFlight(dev)
    for ep in range(start_epoch, epochs):
        if place.pool is not None:
            place.pool.load(slice_for(ep, place.pool.R, epochs, resident_rotate_schedule))

        def steps():
            if place.loader is not None:
                for batch in place.loader:
                    yield step_xy(*ring(shard_batch(batch, mesh)))
                    inflight.add()
                return
            # the epoch's batches go to the device in one copy, as in the
            # JAX trainer: a copy from host memory waits for the card's queue
            draws = (epoch_batches(train_idx, batch_size, rng) if early_w is None
                     else weighted_epoch_batches(train_idx, batch_size, rng, early_w))
            batches = torch.as_tensor(np.stack([shard_batch(b, mesh) for b in draws]),
                                      dtype=torch.long, device=dev)
            for idx in batches:
                yield step(idx)
                inflight.add()

        loss_acc, first_loss, nb = None, None, 0
        for loss, g_norm in steps():
            loss_acc = loss if loss_acc is None else loss_acc + loss
            first_loss = loss if first_loss is None else first_loss
            nb += 1
        if torch.distributed.is_initialized():
            loss_acc, first_loss, loss = mean_over_ranks(torch.stack([loss_acc, first_loss,
                                                                      loss]), mesh)
        gstep += nb
        if lead and log_every and (gstep // log_every) != ((gstep - nb) // log_every):
            logger.log(gstep, train_loss=float(loss), grad_norm=float(g_norm), epoch=ep)
        train_loss = float(loss_acc) / max(nb, 1)
        if swa_start_ep is not None and ep >= swa_start_ep:
            # running mean of the per-epoch weights inside the SWA window
            swa_n += 1
            now = [p.detach() for p in params.values()]
            if swa is None:
                swa = [t.clone() for t in now]
            else:
                diff = torch._foreach_sub(now, swa)
                torch._foreach_mul_(diff, 1.0 / swa_n)
                torch._foreach_add_(swa, diff)
        if ep % model_update == 0:
            val_sum, vb = 0.0, 0
            for b in range(0, len(test_idx), batch_size):
                val_sum += float(val(test_idx_dev[b:b + batch_size]))
                vb += 1
            val_loss = val_sum / max(vb, 1)
            history.append({"epoch": ep, "train_loss": train_loss, "val_loss": val_loss,
                            "first_step_loss": float(first_loss), "last_step_loss": float(loss)})
            if lead:
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
    record_run(ring, place.pool)
    return TransformerTrainResult(
        params=transformer_state_dict_to_flax(params), best_val=best_val, history=history,
        swa_params=None if swa is None else transformer_state_dict_to_flax(dict(zip(params, swa))))


def run_transformer_training(
    *,
    base_path: str,
    aux_path: str | None = None,
    dataset_family: str = "ns",
    if_aux: bool = True,
    if_downsample: bool = False,
    sim_name: str = "ns_incom_inhom_2d_256",
    aux_name: str = "ns_aux_2d_256",
    test_range=(250, 275),
    train_subsample=(900, 900, 900),
    num_aux_samples: int = 24,
    auxiliary_weight: float = 0.7,
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
    aux_shared_head: bool = False,
    swa_frac: float = 0.0,
    swa_lr_factor: float = 0.1,
    early_window_boost: float = 0.0,
    early_window_t0: int = 12,
    aux_store_dtype: str | None = None,
    aux_upsample_at_gather: bool = False,
    primary_store_dtype: str | None = None,
    host_stream: bool = False,
    resident_rotate: int = 0,
    resident_rotate_schedule: str = "block",
    init_params: dict | None = None,
    device=None,
) -> TransformerTrainResult:
    """Train the transformer from the NS files (``{sim_name}-{i}.h5``, with
    ``if_aux`` the aux files ``{aux_name}-{i}.h5`` under ``aux_path`` paired
    per file) or the DR files under ``base_path`` / ``aux_path``; the
    keywords and defaults are JAX's.  ``train_subsample`` = (baseline, aux
    primary, aux) counts.  On NS aux ``primary_store_dtype`` and
    ``aux_store_dtype`` ``"bf16"`` keep the train stores in bf16 and
    ``aux_upsample_at_gather`` keeps an aux store of another resolution at
    its own (the step upsamples); elsewhere, where JAX ignores them, they
    raise ValueError.  ``host_stream`` and ``resident_rotate`` keep the
    train stores in host RAM (``_train``)."""
    resident_rotate = int(resident_rotate or 0)
    if dataset_family not in ("ns", "dr"):
        raise ValueError(f"unknown dataset_family {dataset_family!r}")
    store_opts = {"aux_store_dtype": aux_store_dtype is not None,
                  "primary_store_dtype": primary_store_dtype is not None,
                  "aux_upsample_at_gather": aux_upsample_at_gather}
    given = [k for k, on in store_opts.items() if on]
    if given and (dataset_family == "dr" or not if_aux):
        raise ValueError(f"{', '.join(given)}: store options of the NS aux path; the "
                         f"{'DR' if dataset_family == 'dr' else 'baseline'} stores stay f32 at "
                         "the primary resolution")
    dev = resolve_device(device)
    # the train stores stay in host RAM where a stream of batches or a slice
    # goes to the device instead; the test store goes there
    windows = dict(initial_step=initial_step, rollout_test=rollout_test, device=dev,
                   to_device=not (host_stream or resident_rotate > 1))
    sub = train_subsample[0] if isinstance(train_subsample, (list, tuple)) else train_subsample
    if dataset_family == "ns":
        from sciml_pde_torch.data.ns import load_ns_aux, load_ns_baseline

        if if_aux:
            ds = load_ns_aux(base_path, aux_path, train_subsample=tuple(train_subsample),
                             num_aux_samples=num_aux_samples, sim_name=sim_name,
                             aux_name=aux_name, if_downsample=if_downsample,
                             test_range=test_range, aux_store_dtype=aux_store_dtype,
                             store_dtype=primary_store_dtype,
                             aux_upsample_at_gather=aux_upsample_at_gather, **windows)
        else:
            ds = load_ns_baseline(base_path, train_subsample=sub, sim_name=sim_name,
                                  test_range=test_range, **windows)
    else:
        from sciml_pde_torch.data.dr import load_dr_aux, load_dr_baseline

        if if_aux:
            ds = load_dr_aux(base_path, aux_path, train_subsample=tuple(train_subsample),
                             num_aux_samples=num_aux_samples, if_downsample=if_downsample,
                             **windows)
        else:
            ds = load_dr_baseline(base_path, train_subsample=sub, **windows)
    common = dict(
        img_size=img_size, patch_size=patch_size, tubelet_size=tubelet_size,
        in_chans=in_chans, encoder_embed_dim=encoder_embed_dim, encoder_depth=encoder_depth,
        encoder_num_heads=encoder_num_heads, decoder_embed_dim=decoder_embed_dim,
        decoder_depth=decoder_depth, decoder_num_heads=decoder_num_heads,
        drop_path_rate=drop_path_rate, use_checkpoint=use_checkpoint, bf16=bf16,
        initial_step=initial_step, batch_size=batch_size, epochs=epochs,
        learning_rate_share=learning_rate_share, learning_rate_heads=learning_rate_heads,
        scheduler=scheduler, grad_accum=grad_accum, clip=clip, warmup_steps=warmup_steps,
        model_update=model_update, seed=seed, run_dir=run_dir, model_name=model_name,
        continue_training=continue_training, pretrained_path=pretrained_path,
        log_every=log_every, loss_type=loss_type, fourier_weight=fourier_weight,
        swa_frac=swa_frac, swa_lr_factor=swa_lr_factor, early_window_boost=early_window_boost,
        early_window_t0=early_window_t0, init_params=init_params, host_stream=host_stream,
        resident_rotate=resident_rotate, resident_rotate_schedule=resident_rotate_schedule,
        device=dev,
    )
    if if_aux:
        return train_transformer_aux(ds, num_aux_samples=num_aux_samples,
                                     auxiliary_weight=auxiliary_weight,
                                     aux_shared_head=aux_shared_head, **common)
    return train_transformer_baseline(ds, **common)
