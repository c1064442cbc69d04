"""FNO trainers and evaluation, 2D and 3D (port of
``sciml_pde_tpu/train/fno_train.py``: ``build_baseline_step``,
``build_aux_step``, ``run_training``).

Three steps train an FNO, chosen as the JAX package chooses:

  production (the default)  the plain ``FNO2d`` or ``FNO3d`` (the ``dft2``
                            spectral conv unless ``SCIML_SPECTRAL_IMPL``
                            says otherwise), nRMSE loss, single-step or
                            teacher-forced autoregressive, the production
                            optimizer of ``train/optim.py`` (adaptive clip,
                            L2 + Adam, cosine or StepLR); with
                            ``lie_augment`` each gathered window is
                            Lie-transformed on the device (``sim/lie.py``)
  fused                     ``fast_step=True`` or ``SCIML_FAST_STEP=1``: the
                            whole 2D model in hand-written CUDA kernels and
                            the flat-vector optimizer of
                            ``train/fast_step.py``, for the single-step,
                            rollout-1, cosine 2D baseline only (DR or NS).
                            An explicit ``True`` on another configuration
                            raises; the environment variable gives way to
                            the production step there.
  aux                       ``if_aux=True``: the two-head ``FNO2dAux`` or
                            ``FNO3dAux`` on the primary stream and its
                            decomposed forms (primary ``p`` with aux rows
                            ``p * nA + j`` at the same t0, or NS's per-file
                            ``aux_row_map``), loss ``lp + auxiliary_weight *
                            la``, the optimizer per group (backbone
                            ``learning_rate_share``, heads
                            ``learning_rate_fc2``), checkpoints on the best
                            primary validation loss.  ``aux_chunks`` splits
                            the aux stream into equal chunks, each
                            recomputed in the backward pass; an aux store of
                            another resolution is upsampled to the primary
                            grid inside the step, or with
                            ``aux_native_compute`` runs at its own grid.

``model_family="transformer3d"`` puts the 3D VideoMAE operator
(``models/transformer3d.py``: ``Transformer3DBaseline``, or with ``if_aux``
``Transformer3DAux``, sized by ``transformer_kwargs``) on a 3D store in the
FNO's place, through the same production and aux steps and optimizers.

``fno_remat`` recomputes each spectral block in the backward pass.
``run_training`` loads the stores of ``dataset_family`` (``dr``, ``ns``,
``ns3d``) from their HDF5 files and calls ``train_baseline`` or
``train_aux``; a caller that already holds the stores in memory enters
there with a dataset of ``data/dr.py``, ``data/ns.py`` or ``data/ns3d.py``.
Per epoch: shuffled window batches (one copy to the device) -> a step each
-> validation loss -> best-validation checkpoint (the flax-layout parameter
tree plus the step's optimizer state), written at most once a minute and
flushed at the end.  ``utils/logging.py::MetricLogger`` writes
``{run_dir}/{model_name}.jsonl`` (and echoes it): the training scalars when
``log_every`` crosses, the validation loss on every validated epoch.

``if_training=False`` evaluates instead (``evaluate_checkpoint``, which
takes the test split in memory): it restores
``{run_dir}/{model_name}_ckpt``, unrolls ``rollout_test`` steps over the
test split, and writes the six metrics to ``{model_name}.pickle`` and the
RMSE of each step to ``{model_name}_mse_time.npz``, as JAX writes them,
and with ``plot`` the field render ``{model_name}_pred.png``.

Where the train stores live (``place_stores``; JAX's guards in
``check_placement``):

  ``host_stream``        the stores stay in host RAM; ``data/stream.py``'s
                         loaders gather each batch on the host (a prefetch
                         thread), a ring of pinned buffers takes it to the
                         card, and the step's ``xy`` variant trains on it,
                         at most 8 steps in flight
  ``resident_rotate=R``  the pool stays in host RAM, a 1/R trajectory slice
                         on the device, swapped between epochs under the
                         ``block``, ``interleave`` or ``cyclic`` schedule
  ``shard_store``        rank r of the process group holds trajectories
                         [r N/n, (r+1) N/n) and samples shard-major batches

Over the ranks of a process group (``parallel.distributed_init``) every
production run is data parallel: each rank its rows of each batch, the
gradients' mean over the ranks before the adaptive clip (so every rank sees
the global batch's gradient and norm), the test store on every rank, the
checkpoint and the metric log from rank 0.  The production step carries
JAX's ``scan`` (K steps over an index chunk, no host sync in the loop) and
``xy`` (pre-gathered windows) variants; the aux step carries ``xy``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.dr import (
    DRBaselineDataset,
    load_dr_aux,
    load_dr_baseline,
    load_dr_test,
    resize_linear,
)
from sciml_pde_torch.data.ns import NSBaselineDataset, load_ns_aux, load_ns_baseline, load_ns_test
from sciml_pde_torch.data.ns3d import load_ns3d_aux, load_ns3d_test
from sciml_pde_torch.data.windows import (
    WindowedTrajectories,
    check_aux_pairing,
    epoch_batches,
    gather_windows,
    make_aux_indices,
    sharded_epoch_batches,
)
from sciml_pde_torch.eval.rollout import METRIC_NAMES, evaluate_rollout, rollout_predict
from sciml_pde_torch.metrics import nrmse_loss
from sciml_pde_torch.models.fno import FNO2d, FNO2dAux, FNO3d, FNO3dAux
from sciml_pde_torch.models.transformer3d import Transformer3DAux, Transformer3DBaseline
from sciml_pde_torch.parallel import (
    data_parallel,
    make_mesh,
    mean_over_ranks,
    replicate,
    shard_batch,
)
from sciml_pde_torch.sim import lie
from sciml_pde_torch.ops.fno_fused_step import fno2d_fused_apply
from sciml_pde_torch.train import fast_step as fs
from sciml_pde_torch.train.optim import aux_group_of, make_grouped_optimizer, make_optimizer
from sciml_pde_torch.train.placement import (
    InFlight,
    PinnedRing,
    Placement,
    place_stores,
    record_run,
    slice_for,
)
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
    tree_map,
)

_CKPT_MIN_INTERVAL_S = 60.0


@dataclasses.dataclass
class FNOTrainResult:
    params: Any  # flax-layout FNO2d or FNO2dAux tree of numpy arrays
    best_val: float
    history: list[dict]


def select_fast_step(fast_step: bool | None, *, if_aux=False, model_family="fno",
                     training_type="single", rollout_test=1, lie_augment=False,
                     shard_store=False, host_stream=False, resident_rotate=0,
                     scheduler="cosine", n_data=1) -> bool:
    """Whether the fused step trains this configuration.  ``None`` reads
    ``SCIML_FAST_STEP``; an explicit ``True`` on a configuration the fused
    step does not run (``n_data``: the ranks of the data axis, one for the
    fused step) raises with JAX's words, the environment variable gives
    way."""
    requested = (fast_step if fast_step is not None
                 else os.environ.get("SCIML_FAST_STEP", "").lower() in ("1", "true"))
    compatible = (
        not if_aux and model_family == "fno" and training_type == "single"
        and rollout_test == 1 and not lie_augment and not shard_store and not host_stream
        and int(resident_rotate or 0) <= 1 and scheduler == "cosine" and n_data == 1
    )
    if requested and not compatible:
        if fast_step:
            raise ValueError(
                "fast_step=True requires the plain 2D FNO baseline path "
                "(no aux/3D/autoregressive/lie/shard/stream/rotation, "
                "rollout_test=1, cosine schedule) on a single-device mesh"
            )
        return False
    return bool(requested)


def make_fno(num_channels: int, modes: int, width: int, initial_step: int, *,
             aux: bool = False, ndim: int = 2, remat: bool = False,
             generator: torch.Generator | None = None):
    """The plain FNO the trainers build: ``FNO2d`` / ``FNO3d`` (``ndim``
    spatial axes), two-head with ``aux``, ``modes`` on every axis."""
    cls = {(2, False): FNO2d, (2, True): FNO2dAux, (3, False): FNO3d, (3, True): FNO3dAux}
    return cls[ndim, aux](num_channels, *(modes,) * ndim, width=width,
                          initial_step=initial_step, generator=generator, remat=remat)


def default_init_tree(num_channels: int, modes: int, width: int, initial_step: int,
                      seed: int, aux: bool = False, ndim: int = 2) -> dict:
    """Flax-layout tree of a freshly initialised port FNO (``make_fno``)."""
    model = make_fno(num_channels, modes, width, initial_step, aux=aux, ndim=ndim,
                     generator=torch.Generator().manual_seed(seed))
    return state_dict_to_flax(model.state_dict())


_FAMILIES_MODEL = ("fno", "transformer3d")


def transformer3d_core_kwargs(transformer_kwargs: dict | None, spatial: tuple[int, ...],
                              num_channels: int, initial_step: int) -> dict:
    """The 3D VideoMAE core's keywords as the JAX trainer builds them: the
    store's spatial shape, ``patch_size`` (10, 10, 9) and ``tubelet_size`` 5
    unless ``transformer_kwargs`` says otherwise, and the widths, depths,
    heads, ``drop_path_rate`` and ``use_checkpoint`` it gives."""
    tk = transformer_kwargs or {}
    core = dict(img_size=tuple(spatial), patch_size=tuple(tk.get("patch_size", (10, 10, 9))),
                tubelet_size=tk.get("tubelet_size", 5), in_chans=num_channels,
                num_frames=initial_step)
    for k in ("encoder_dim", "encoder_depth", "encoder_heads", "decoder_dim", "decoder_depth",
              "decoder_heads", "drop_path_rate", "use_checkpoint"):
        if k in tk:
            core[k] = tk[k]
    return core


class _Family:
    """The model family of a run: its module (seeded), its default tree and
    its weight conversions."""

    def __init__(self, model_family: str, transformer_kwargs: dict | None, store,
                 num_channels: int, modes: int, width: int, initial_step: int, *, aux: bool,
                 remat: bool = False):
        if model_family not in _FAMILIES_MODEL:
            raise ValueError(f"unknown model_family {model_family!r}; one of {_FAMILIES_MODEL}")
        self.ndim = _spatial_ndim(store)
        self.transformer = model_family == "transformer3d"
        if self.transformer and self.ndim != 3:
            raise ValueError("model_family='transformer3d' trains on a 3D store (N, T, X, Y, Z, "
                             f"C), got {tuple(store.data.shape)}")
        if transformer_kwargs is not None and not self.transformer:
            raise ValueError("transformer_kwargs goes with model_family='transformer3d'")
        self.aux, self.remat = aux, remat
        self.fno_args = (num_channels, modes, width, initial_step)
        if self.transformer:
            self.core = transformer3d_core_kwargs(transformer_kwargs, store.data.shape[2:5],
                                                  num_channels, initial_step)
            self.to_sd, self.to_tree = transformer_flax_to_state_dict, transformer_state_dict_to_flax
        else:
            self.to_sd, self.to_tree = flax_to_state_dict, state_dict_to_flax

    def model(self, generator: torch.Generator | None = None):
        if self.transformer:
            cls = Transformer3DAux if self.aux else Transformer3DBaseline
            return cls(**self.core, generator=generator)
        return make_fno(*self.fno_args, aux=self.aux, ndim=self.ndim, remat=self.remat,
                        generator=generator)

    def default_tree(self, seed: int) -> dict:
        if self.transformer:
            return self.to_tree(self.model(torch.Generator().manual_seed(seed)).state_dict())
        return default_init_tree(*self.fno_args, seed, aux=self.aux, ndim=self.ndim)


def build_baseline_step(model, opt, initial_step: int, rollout: int,
                        training_type: str = "single", t_train: int | None = None,
                        lie_augment: bool = False, generator: torch.Generator | None = None):
    """The production step on the plain model (port of JAX's
    ``build_baseline_step``).  Returns ``step(data, grid, idx) -> (loss,
    g_norm)``, which updates the model's parameters in place through ``opt``
    (``g_norm`` is the pre-clip global norm), and ``val_loss(data, grid,
    idx) -> loss``.  ``grid`` is (X, Y, 2), ``idx`` (B, 2) window rows.

    ``step.scan(data, grid, idx_chunk) -> (losses, g_norms)`` runs one step
    per (B, 2) block of a (K, B, 2) chunk and returns length-K tensors on the
    device, with no host sync in the loop; ``step.xy(x, y, grid) -> (loss,
    g_norm)`` takes windows gathered already (x (B, X, Y, T0, C), y
    (B, X, Y, rollout, C)).

    ``training_type="autoregressive"``: teacher-forced unroll over
    ``(t_train or initial_step + rollout) - initial_step`` target frames --
    the model predicts from the window, the loss adds up, the true frame
    slides in -- so a window may run past the end of its trajectory, where
    the gather clamps.

    ``lie_augment``: each training window (input and target frames
    together) is Lie-transformed on the device with its own strengths, drawn
    from ``generator`` (on the step's device) by ``lie.sample_strengths``;
    validation sees the windows as they are."""
    params = dict(model.named_parameters())
    if training_type == "autoregressive":
        gather_rollout = (t_train or initial_step + rollout) - initial_step

        def loss_fn(x, y, grid):
            total = None
            for t in range(y.shape[-2]):
                yt = y[..., t:t + 1, :]
                loss_t = nrmse_loss(model(x, grid), yt)
                total = loss_t if total is None else total + loss_t
                x = torch.cat([x[..., 1:, :], yt], dim=-2)
            return total
    elif training_type == "single":
        gather_rollout = rollout

        def loss_fn(x, y, grid):
            return nrmse_loss(model(x, grid), y)
    else:
        raise ValueError(f"unknown training_type {training_type!r}")

    def batch(data, grid, idx):
        x, y = gather_windows(data, idx, initial_step, gather_rollout)
        return x.float(), y.float(), grid.expand(idx.shape[0], *grid.shape)

    def maybe_augment(x, y):
        if not lie_augment:
            return x, y
        win = torch.cat([x, y], dim=-2)
        win = lie.augment_ns_window(win, lie.sample_strengths(generator, win.shape[0],
                                                              win.device))
        return win[..., :initial_step, :], win[..., initial_step:, :]

    def update(x, y, gb):
        loss = loss_fn(*maybe_augment(x, y), gb)
        grads = torch.autograd.grad(loss, list(params.values()))
        g_norm = opt.step(params, dict(zip(params, grads)))
        return loss.detach(), g_norm

    def step(data, grid, idx):
        return update(*batch(data, grid, idx))

    def step_xy(x, y, grid):
        return update(x.float(), y.float(), grid.expand(x.shape[0], *grid.shape))

    def step_scan(data, grid, idx_chunk):
        losses, g_norms = zip(*(step(data, grid, idx) for idx in idx_chunk))
        return torch.stack(losses), torch.stack(g_norms)

    @torch.no_grad()
    def val_loss(data, grid, idx):
        return loss_fn(*batch(data, grid, idx))

    step.xy, step.scan = step_xy, step_scan
    return step, val_loss


def build_aux_step(model, opt, initial_step: int, rollout: int, num_aux_samples: int,
                   auxiliary_weight: float, aux_row_map: np.ndarray | None = None,
                   aux_chunks: int = 1, aux_resize_to: tuple[int, ...] | None = None,
                   aux_native_grid: torch.Tensor | None = None):
    """The aux joint-training step on the device stores (port of JAX's
    ``build_aux_step``).  Returns ``step(data_p, data_a, grid, idx) ->
    ((loss, lp, la), g_norm)``, which updates the model's parameters in
    place through ``opt`` (``g_norm`` is the pre-clip global norm), and
    ``val_primary_loss(data_p, grid, idx) -> loss``.

    Pairing: primary trajectory ``p`` with aux rows ``p * num_aux_samples +
    j`` at the same t0 (DR, 3D), or ``aux_row_map[p, j]`` ((Np, nA), NS's
    per-file pairing); the aux batch is flattened p-major to B *
    num_aux_samples and cast to f32 after the gather (a store may be bf16).
    By default the backbone runs once over both streams, and loss = lp +
    auxiliary_weight * la.  Otherwise the primary stream runs through
    ``model.primary`` and the aux stream through ``model.auxiliary`` in
    ``aux_chunks`` equal chunks, each recomputed in the backward pass, la
    the mean of the chunks' losses (the same gradient: instance norm is per
    sample):

      ``aux_chunks > 1``   the chunks alone;
      ``aux_resize_to``    each chunk's windows, input and target, upsampled
                           to that spatial shape (JAX's linear resize), the
                           aux stream on the primary grid;
      ``aux_native_grid``  the aux stream at the store's resolution on this
                           grid.  Exclusive with ``aux_resize_to``.

    ``step.xy(x, y, xa, ya, grid) -> ((loss, lp, la), g_norm)`` takes the
    windows gathered already (``data/stream.py::AuxHostWindowLoader``), the
    aux windows at the primary resolution, or with ``aux_native_grid`` at
    the store's, where the two streams run through ``model.primary`` and
    ``model.auxiliary`` apart.

    Validation scores the primary head alone: the primary stream goes to
    both inputs and the aux output is dropped, as in JAX."""
    if aux_resize_to is not None and aux_native_grid is not None:
        raise ValueError("aux_resize_to and aux_native_grid are exclusive")
    params = dict(model.named_parameters())
    aux_indices = make_aux_indices(num_aux_samples, aux_row_map)
    chunked = aux_chunks > 1 or aux_resize_to is not None or aux_native_grid is not None

    def to_model_res(a):
        """f32 cast and linear upsample of (B, *spatial, T, C) aux windows."""
        a = a.float()
        if aux_resize_to is not None and tuple(a.shape[1:-2]) != tuple(aux_resize_to):
            a = resize_linear(a, dict(enumerate(aux_resize_to, start=1)))
        return a

    def chunk_loss(xa_c, ya_c, ga):
        return nrmse_loss(model.auxiliary(to_model_res(xa_c), ga), to_model_res(ya_c))

    def losses(x, y, xa, ya, grid):
        gb = grid.expand(x.shape[0], *grid.shape)
        if not chunked:
            pred_p, pred_a = model(x, gb, xa.float(), grid.expand(xa.shape[0], *grid.shape))
            return nrmse_loss(pred_p, y), nrmse_loss(pred_a, ya.float())
        lp = nrmse_loss(model.primary(x, gb), y)
        n_aux = xa.shape[0]
        if n_aux % aux_chunks:
            raise ValueError(f"aux batch {n_aux} not divisible by aux_chunks={aux_chunks}")
        cb = n_aux // aux_chunks
        g_a = grid if aux_native_grid is None else aux_native_grid
        ga = g_a.expand(cb, *g_a.shape)
        la = sum(checkpoint(chunk_loss, xa[k * cb:(k + 1) * cb], ya[k * cb:(k + 1) * cb], ga,
                            use_reentrant=False) for k in range(aux_chunks))
        return lp, la / aux_chunks

    def update(lp, la):
        loss = lp + auxiliary_weight * la
        grads = torch.autograd.grad(loss, list(params.values()))
        g_norm = opt.step(params, dict(zip(params, grads)))
        return (loss.detach(), lp.detach(), la.detach()), g_norm

    def step(data_p, data_a, grid, idx):
        x, y = gather_windows(data_p, idx, initial_step, rollout)
        xa, ya = gather_windows(data_a, aux_indices(idx), initial_step, rollout)
        return update(*losses(x.float(), y.float(), xa, ya, grid))

    def step_xy(x, y, xa, ya, grid):
        x, y, xa, ya = x.float(), y.float(), xa.float(), ya.float()
        gb = grid.expand(x.shape[0], *grid.shape)
        if aux_native_grid is None:
            pred_p, pred_a = model(x, gb, xa, grid.expand(xa.shape[0], *grid.shape))
        else:
            # streams of two resolutions: the primary and auxiliary methods
            # apart (the joint call's outputs, JAX's loss_fn_split)
            pred_p = model.primary(x, gb)
            pred_a = model.auxiliary(xa, aux_native_grid.expand(xa.shape[0],
                                                                *aux_native_grid.shape))
        return update(nrmse_loss(pred_p, y), nrmse_loss(pred_a, ya))

    @torch.no_grad()
    def val_primary_loss(data_p, grid, idx):
        x, y = gather_windows(data_p, idx, initial_step, rollout)
        gb = grid.expand(idx.shape[0], *grid.shape)
        pred_p, _ = model(x.float(), gb, x.float(), gb)
        return nrmse_loss(pred_p, y.float())

    step.xy = step_xy
    return step, val_primary_loss


class _ProductionRun:
    """Model, optimizer and step of a branch that trains the plain model:
    the production baseline or aux joint training.  ``make_opt(params)``
    builds the optimizer and ``make_step(model, opt)`` returns ``step(data,
    grid, idx) -> (loss, g_norm)`` and ``val(data, grid, idx) -> loss``."""

    def __init__(self, model, tree, dev, make_opt, make_step, weights=(flax_to_state_dict,
                                                                       state_dict_to_flax)):
        self.to_sd, self.to_tree = weights
        model.load_state_dict(self.to_sd(tree))
        self.model = model.to(dev)
        self.params = dict(self.model.named_parameters())
        self.opt = make_opt(self.params)
        self.step, self.val = make_step(self.model, self.opt)
        self.step_xy = self.step.xy

    def snapshot(self):
        return ({n: p.detach().clone() for n, p in self.params.items()},
                {"m": {n: t.clone() for n, t in self.opt.m.items()},
                 "v": {n: t.clone() for n, t in self.opt.v.items()},
                 "count": self.opt.count})

    def tree(self, params=None) -> dict:
        return self.to_tree(self.params if params is None else params)

    def opt_tree(self, state: dict):
        """A ``snapshot``'s optimizer state as optax's tree."""
        return self.opt.optax_tree(state, self.to_tree)

    def restore(self, ck) -> None:
        self.model.load_state_dict(self.to_sd(ck["params"]))
        self.opt.load_state_dict(self.opt.state_from_optax(ck["opt_state"], self.to_sd))


class _FusedRun:
    """Flat parameters, optimizer state and step of the fused branch."""

    def __init__(self, tree, dev, *, modes, initial_step, learning_rate, total_steps):
        self.dev, self.modes, self.initial_step = dev, modes, initial_step
        self.theta, self.spec = fs.fast_state_from_tree(tree, modes, dev)
        self.opt = fs.init_opt(self.theta)
        self._step, _ = fs.build_fast_baseline_step(modes, initial_step, self.spec,
                                                    learning_rate, total_steps)

    def step(self, data, grid, idx):
        grid2 = grid.permute(2, 0, 1).contiguous()
        self.theta, self.opt, loss, g_norm = self._step(self.theta, self.opt, data, grid2, idx)
        return loss, g_norm

    @torch.no_grad()
    def val(self, data, grid, idx):
        x, y = fs.fast_gather(data, idx, self.initial_step)
        p = fs.unflatten_params(self.theta, self.spec)
        pred = fno2d_fused_apply(x, grid.permute(2, 0, 1).contiguous(), p, self.modes,
                                 self.modes)
        return fs.nrmse_loss_cf(pred, y)

    def snapshot(self):
        return self.theta.clone(), {"m": self.opt.m.clone(), "v": self.opt.v.clone(),
                                    "count": self.opt.count}

    def tree(self, theta=None) -> dict:
        theta = self.theta if theta is None else theta
        return tree_map(lambda t: t.cpu().numpy(),
                        fs.tree_from_fast_state(theta, self.spec, self.modes))

    def opt_tree(self, state: dict) -> dict:
        return fs.opt_tree(fs.FlatOptState(state["m"], state["v"], state["count"]), self.spec)

    def restore(self, ck) -> None:
        self.opt = fs.opt_from_tree(ck["opt_state"], self.spec, self.dev)
        self.theta, _ = fs.fast_state_from_tree(ck["params"], self.modes, self.dev)


def _fit(run, place: Placement, test_w: WindowedTrajectories, *, batch_size: int,
         epochs: int, model_update: int, seed: int, run_dir: str, model_name: str,
         continue_training: bool, log_every: int,
         resident_rotate_schedule: str = "block") -> FNOTrainResult:
    """The epoch loop of every step: batches from
    ``numpy.random.default_rng(seed)`` (or the host loader, seeded the same),
    validation every ``model_update`` epochs, best-validation checkpoints at
    ``{run_dir}/{model_name}_ckpt``.  Host batches reach the card through
    a ``PinnedRing`` with at most ``STREAM_PIPELINE`` steps in flight; a
    rotating pool loads the slice of each epoch first.  Over several ranks
    each takes its rows of every batch (``shard_batch``), the losses are
    means over the ranks, and only rank 0 logs and writes checkpoints."""
    mesh, train_w = place.mesh, place.train_w
    lead = mesh.rank == 0
    logger = MetricLogger(run_dir, name=model_name, echo_every=1) if lead else None
    rng = np.random.default_rng(seed)
    train_idx, test_idx = place.train_idx, test_w.window_index()
    dev = test_w.data.device
    ckpt_path = Path(run_dir) / f"{model_name}_ckpt"
    best_val, start_epoch = math.inf, 0
    if continue_training and ckpt_path.exists():
        ck = restore_checkpoint(ckpt_path)
        run.restore(ck)
        start_epoch, best_val = int(ck["meta"]["epoch"]), float(ck["meta"]["loss"])

    def save(state, ep, val):
        if lead:
            save_checkpoint(ckpt_path, run.tree(state[0]), run.opt_tree(state[1]), ep, val)

    ring, inflight = PinnedRing(dev), InFlight(dev)
    n_data = mesh.shape["data"]
    test_idx_dev = torch.as_tensor(test_idx, dtype=torch.long, device=dev)
    history: list[dict] = []
    gstep, best_state, dirty, last_ckpt_t = 0, None, False, 0.0
    for ep in range(start_epoch, epochs):
        if place.pool is not None:
            place.pool.load(slice_for(ep, place.pool.R, epochs, resident_rotate_schedule))
        loss_acc, first_loss, nb = None, None, 0

        def steps():
            if place.loader is not None:
                for batch in place.loader:
                    yield run.step_xy(*ring(shard_batch(batch, mesh)), train_w.grid)
                    inflight.add()
                return
            # the epoch's batches go to the device in one copy, as the JAX
            # trainer stages them: a copy from host memory waits for the queue
            draws = (epoch_batches(train_idx, batch_size, rng) if place.shard_n_traj is None
                     else sharded_epoch_batches(train_idx, batch_size, place.shard_n_traj,
                                                n_data, rng))
            batches = torch.as_tensor(np.stack([shard_batch(b, mesh) for b in draws]),
                                      dtype=torch.long, device=dev)
            for idx in batches:
                yield run.step(train_w.data, train_w.grid, idx)

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
        if ep % model_update == 0:
            val_sum, vb = 0.0, 0
            for b in range(0, len(test_idx), batch_size):
                val_sum += float(run.val(test_w.data, test_w.grid,
                                         test_idx_dev[b:b + batch_size]))
                vb += 1
            val = val_sum / max(vb, 1)
            history.append({"epoch": ep, "train_loss": train_loss, "val_loss": val,
                            "first_step_loss": float(first_loss),
                            "last_step_loss": float(loss)})
            if lead:
                logger.log(gstep, epoch=ep, val_loss=val)
            if val < best_val:
                best_val, best_state = val, (run.snapshot(), ep)
                if time.time() - last_ckpt_t > _CKPT_MIN_INTERVAL_S:
                    save(best_state[0], ep, best_val)
                    last_ckpt_t, dirty = time.time(), False
                else:
                    dirty = True
    if dirty and best_state is not None:
        save(best_state[0], best_state[1], best_val)
    record_run(ring, place.pool)
    return FNOTrainResult(params=run.tree(), best_val=best_val, history=history)


def _total_steps(train_idx: np.ndarray, batch_size: int, epochs: int) -> int:
    return epochs * max(len(train_idx) // batch_size, 1)


def _spatial_ndim(w: WindowedTrajectories) -> int:
    """Spatial axes of a store (N, T, *spatial, C): 2 or 3."""
    ndim = w.data.ndim - 3
    if ndim not in (2, 3):
        raise ValueError(f"a store (N, T, *spatial, C) with 2 or 3 spatial axes, got "
                         f"{tuple(w.data.shape)}")
    return ndim


def train_baseline(
    dataset: DRBaselineDataset | NSBaselineDataset,
    *,
    modes: int = 12,
    width: int = 20,
    initial_step: int = 10,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate: float = 1e-3,
    scheduler: str = "cosine",
    scheduler_step: int = 100,
    scheduler_gamma: float = 0.5,
    training_type: str = "single",
    t_train: int = 101,
    lie_augment: bool = False,
    fno_remat: bool = False,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    continue_training: bool = False,
    log_every: int = 50,
    init_params: dict | None = None,
    fast_step: bool | None = None,
    model_family: str = "fno",
    transformer_kwargs: dict | None = None,
    host_stream: bool = False,
    resident_rotate: int = 0,
    resident_rotate_schedule: str = "block",
    shard_store: bool = False,
    device=None,
) -> FNOTrainResult:
    """Train the baseline FNO on an in-memory store: ``FNO2d`` on a store
    (N, T, X, Y, C), ``FNO3d`` on (N, T, X, Y, Z, C) (``dataset.train`` /
    ``dataset.test``, any family); with ``model_family="transformer3d"``
    the ``Transformer3DBaseline`` of ``transformer_kwargs`` on a 3D store.

    The windows' rollout (``dataset.train.rollout``) is ``rollout_test``.
    ``init_params`` (flax-layout tree) replaces the seeded initialisation,
    so a run can start from the same weights as a JAX run.  Batches come
    from ``numpy.random.default_rng(seed)``, as in the JAX trainer; the Lie
    strengths from a ``torch.Generator`` on the device seeded with
    ``seed``.  The fused step runs the 2D model only: an explicit
    ``fast_step=True`` on a 3D store raises, as in JAX.

    ``host_stream``, ``resident_rotate`` (with ``resident_rotate_schedule``)
    and ``shard_store`` place the train store as ``place_stores`` says (the
    production step's ``xy`` trains on streamed batches).  Over the ranks of
    a process group (``parallel.distributed_init``) the run is data
    parallel: each rank its rows of every batch, the gradients' mean over
    the ranks before the clip."""
    dev = resolve_device(device)
    mesh = make_mesh()
    train_w = dataset.train
    family = _Family(model_family, transformer_kwargs, train_w, num_channels, modes, width,
                     initial_step, aux=False, remat=fno_remat)
    use_fast = select_fast_step(fast_step, model_family=model_family,
                                training_type=training_type, rollout_test=train_w.rollout,
                                lie_augment=lie_augment, scheduler=scheduler,
                                shard_store=shard_store, host_stream=host_stream,
                                resident_rotate=resident_rotate, n_data=mesh.shape["data"])
    if use_fast and family.ndim == 3:
        if fast_step:
            raise ValueError("fast_step=True supports only the 2D FNO (3D store)")
        use_fast = False
    place = place_stores(train_w, None, batch_size=batch_size, seed=seed, dev=dev,
                         host_stream=host_stream, resident_rotate=resident_rotate,
                         shard_store=shard_store, mesh=mesh)
    train_w = place.train_w
    total_steps = _total_steps(place.train_idx, batch_size, epochs)
    tree = init_params if init_params is not None else family.default_tree(seed)
    if use_fast:
        run = _FusedRun(tree, dev, modes=modes, initial_step=initial_step,
                        learning_rate=learning_rate, total_steps=total_steps)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed) if lie_augment else None
        run = _ProductionRun(
            family.model(), tree, dev,
            lambda ps: data_parallel(make_optimizer(ps, learning_rate, total_steps, scheduler,
                                                    1e-4, scheduler_step, scheduler_gamma),
                                     mesh),
            lambda m, o: build_baseline_step(m, o, initial_step, train_w.rollout,
                                             training_type, t_train, lie_augment, gen),
            (family.to_sd, family.to_tree))
        replicate(list(run.params.values()), mesh)
    return _fit(run, place, dataset.test, batch_size=batch_size, epochs=epochs,
                model_update=model_update, seed=seed, run_dir=run_dir, model_name=model_name,
                continue_training=continue_training, log_every=log_every,
                resident_rotate_schedule=resident_rotate_schedule)


def train_aux(
    dataset,
    *,
    modes: int = 12,
    width: int = 20,
    initial_step: int = 10,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate_share: float = 1e-3,
    learning_rate_fc2: float = 1e-3,
    num_aux_samples: int = 3,
    auxiliary_weight: float = 0.7,
    aux_chunks: int = 1,
    aux_native_compute: bool = False,
    fno_remat: bool = False,
    scheduler: str = "cosine",
    scheduler_step: int = 100,
    scheduler_gamma: float = 0.5,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    continue_training: bool = False,
    log_every: int = 50,
    init_params: dict | None = None,
    model_family: str = "fno",
    transformer_kwargs: dict | None = None,
    host_stream: bool = False,
    resident_rotate: int = 0,
    resident_rotate_schedule: str = "block",
    shard_store: bool = False,
    device=None,
) -> FNOTrainResult:
    """Aux joint training of ``FNO2dAux`` / ``FNO3dAux`` on in-memory stores
    (``DRAuxDataset``, ``NSAuxDataset``, ``NS3DAuxDataset``); with
    ``model_family="transformer3d"`` of the ``Transformer3DAux`` of
    ``transformer_kwargs`` on 3D stores.

    The primary windows (``dataset.primary_train``) set the epoch; each step
    adds the paired aux windows: ``dataset.aux_row_map`` where the dataset
    has one (NS), else rows ``p * num_aux_samples + j``, which the aux store
    must hold.  An aux store at another spatial resolution is upsampled to
    the primary grid inside the step, or with ``aux_native_compute`` runs at
    its own resolution on the primary grid resized to it (JAX's linear
    resize, which antialiases where it shrinks).  Validation and the
    checkpoint follow the primary head's loss on ``dataset.primary_test``.
    ``init_params`` (a flax aux tree) replaces the seeded initialisation.
    ``host_stream``, ``resident_rotate``, ``resident_rotate_schedule``,
    ``shard_store`` and several ranks as in ``train_baseline`` (the aux
    step's ``xy`` trains on streamed batches)."""
    dev = resolve_device(device)
    mesh = make_mesh()
    train_w, aux_w = dataset.primary_train, dataset.aux_train
    family = _Family(model_family, transformer_kwargs, train_w, num_channels, modes, width,
                     initial_step, aux=True, remat=fno_remat)
    row_map = getattr(dataset, "aux_row_map", None)
    check_aux_pairing(train_w, aux_w, num_aux_samples, row_map)
    prim_sp, aux_sp = tuple(train_w.data.shape[2:-1]), tuple(aux_w.data.shape[2:-1])
    aux_resize_to = aux_native_grid = None
    if aux_sp != prim_sp:
        if aux_native_compute:
            aux_native_grid = resize_linear(train_w.grid, dict(enumerate(aux_sp)))
        else:
            aux_resize_to = prim_sp
    place = place_stores(train_w, aux_w, batch_size=batch_size, seed=seed, dev=dev,
                         num_aux=num_aux_samples, row_map=row_map, host_stream=host_stream,
                         resident_rotate=resident_rotate, shard_store=shard_store, mesh=mesh)
    train_w, aux_w = place.train_w, place.aux_w
    total_steps = _total_steps(place.train_idx, batch_size, epochs)
    tree = init_params if init_params is not None else family.default_tree(seed)

    def make_step(model, opt):
        step, val = build_aux_step(model, opt, initial_step, train_w.rollout, num_aux_samples,
                                   auxiliary_weight, aux_row_map=place.row_map,
                                   aux_chunks=aux_chunks, aux_resize_to=aux_resize_to,
                                   aux_native_grid=aux_native_grid)

        def primary_step(data, grid, idx):
            (loss, _, _), g_norm = step(data, aux_w.data, grid, idx)
            return loss, g_norm

        def primary_step_xy(x, y, xa, ya, grid):
            (loss, _, _), g_norm = step.xy(x, y, xa, ya, grid)
            return loss, g_norm
        primary_step.xy = primary_step_xy
        return primary_step, val

    lrs = {"shared": learning_rate_share, "primary_head": learning_rate_fc2,
           "aux_head": learning_rate_fc2}
    run = _ProductionRun(
        family.model(), tree, dev,
        lambda ps: data_parallel(make_grouped_optimizer(ps, aux_group_of, lrs, total_steps,
                                                        scheduler, 1e-4, scheduler_step,
                                                        scheduler_gamma), mesh),
        make_step, (family.to_sd, family.to_tree))
    replicate(list(run.params.values()), mesh)
    return _fit(run, place, dataset.primary_test, batch_size=batch_size, epochs=epochs,
                model_update=model_update, seed=seed, run_dir=run_dir, model_name=model_name,
                continue_training=continue_training, log_every=log_every,
                resident_rotate_schedule=resident_rotate_schedule)


def evaluate_checkpoint(
    test: WindowedTrajectories,
    *,
    modes: int = 12,
    width: int = 20,
    if_aux: bool = False,
    rollout_test: int = 1,
    batch_size: int = 4,
    iLow: int = 4,
    iHigh: int = 12,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    model_family: str = "fno",
    transformer_kwargs: dict | None = None,
    plot: bool = False,
    channel_plot: int = 0,
    device=None,
) -> FNOTrainResult:
    """The evaluation branch on an in-memory test split: restore
    ``{run_dir}/{model_name}_ckpt`` (written by any of the three steps),
    unroll ``rollout_test`` steps over ``test`` in batches of
    ``batch_size``, and write

      ``{model_name}.pickle``        (RMSE, nRMSE, CSV, Max, BD, F), numpy
                                     float64 each, as JAX pickles them
      ``{model_name}_mse_time.npz``  ``t`` = the unrolled frames' indices,
                                     ``mse`` = each step's RMSE

    The model is 2D or 3D as the test store is (or the 3D transformer of
    ``model_family``, sized by ``transformer_kwargs``).  With ``if_aux`` the
    checkpoint is a two-head model and the primary head is scored (the
    primary stream goes to both inputs, as in JAX).  With ``plot``,
    ``{model_name}_pred.png`` renders channel ``channel_plot`` of the first
    test window's last rollout step beside its target
    (``plots/figures.py::field_panels``).  Returns ``best_val`` = nRMSE and
    ``history`` = [the metrics dict]."""
    dev = resolve_device(device)
    # on the device, and checked to hold initial_step + rollout_test frames
    test = WindowedTrajectories(test.data.to(dev), test.grid.to(dev),
                                initial_step=test.initial_step, rollout=rollout_test,
                                train=False)
    ck = restore_checkpoint(Path(run_dir) / f"{model_name}_ckpt")
    family = _Family(model_family, transformer_kwargs, test, test.data.shape[-1], modes, width,
                     test.initial_step, aux=if_aux)
    model = family.model()
    model.load_state_dict(family.to_sd(ck["params"]))
    model = model.to(dev)

    def apply_fn(x, g):
        return model(x, g, x, g)[0] if if_aux else model(x, g)

    errs = evaluate_rollout(apply_fn, test, rollout_test, batch_size, iLow, iHigh)
    with (Path(run_dir) / f"{model_name}.pickle").open("wb") as f:
        pickle.dump(tuple(errs[k] for k in METRIC_NAMES), f)
    np.savez(Path(run_dir) / f"{model_name}_mse_time.npz",
             t=np.arange(test.initial_step, test.initial_step + rollout_test),
             mse=np.asarray(errs["mse_time"]))
    if plot:
        from sciml_pde_torch.plots.figures import field_panels

        idx0 = torch.as_tensor(test.window_index()[:1], dtype=torch.long, device=dev)
        x0, y0 = gather_windows(test.data, idx0, test.initial_step, rollout_test)
        with torch.no_grad():
            preds = rollout_predict(apply_fn, x0.float(), test.grid[None], rollout_test)
        field_panels(Path(run_dir) / f"{model_name}_pred.png",
                     preds[0, ..., -1, :].cpu().numpy(), y0[0, ..., -1, :].float().cpu().numpy(),
                     channel=channel_plot, title=model_name)
    return FNOTrainResult(params=family.to_tree(model.state_dict()),
                          best_val=errs["nRMSE"], history=[errs])


_FAMILIES = ("dr", "ns", "ns3d")


def check_placement(*, epochs: int, host_stream: bool = False, shard_store: bool = False,
                    resident_rotate: int = 0, resident_rotate_schedule: str = "block",
                    aux_chunks: int = 1, aux_upsample_at_gather: bool = False,
                    aux_native_compute: bool = False) -> None:
    """JAX's refusals of the placement options, in its order, with its
    exception types and words."""
    if resident_rotate > 1 and (host_stream or shard_store):
        raise ValueError(
            "resident_rotate is the device-resident pool-rotation lever; "
            "it composes with neither host_stream nor shard_store"
        )
    if (resident_rotate > 1 and resident_rotate_schedule == "interleave"
            and epochs < 2 * resident_rotate):
        raise ValueError(
            f"resident_rotate_schedule='interleave' needs epochs >= "
            f"2*resident_rotate so both half-runs visit every slice "
            f"(got epochs={epochs}, resident_rotate={resident_rotate}); "
            f"use schedule='block' or raise epochs"
        )
    if host_stream and shard_store:
        raise ValueError("host_stream and shard_store are mutually exclusive")
    if host_stream and aux_chunks > 1:
        raise ValueError(
            "aux_chunks is a device-store lever; the host-stream path "
            "ships pre-gathered windows (the shipped batch is already the "
            "memory granularity)"
        )
    if host_stream and aux_upsample_at_gather and not aux_native_compute:
        raise ValueError(
            "the in-step upsample is a device-store lever; with "
            "host_stream either ship pre-upsampled windows (default) or "
            "run the aux stream at native res (aux_native_compute)"
        )


def run_training(
    *,
    base_path: str,
    aux_path: str | None = None,
    dataset_family: str = "dr",
    lie_augment: bool = False,
    sim_name: str = "ns_incom_inhom_2d_256",
    aux_name: str = "ns_aux_2d_256",
    test_range=(250, 275),
    if_aux: bool = False,
    if_downsample: bool = False,
    aux_file: str | None = None,
    model_family: str = "fno",
    transformer_kwargs: dict | None = None,
    extra_train_files=None,
    train_subsample=(900, 900, 900),
    num_aux_samples: int = 3,
    auxiliary_weight: float = 0.7,
    aux_store_dtype: str | None = None,
    aux_chunks: int = 1,
    aux_upsample_at_gather: bool = False,
    aux_native_compute: bool = False,
    fno_remat: bool = False,
    primary_store_dtype: str | None = None,
    modes: int = 12,
    width: int = 20,
    initial_step: int = 10,
    rollout_test: int = 1,
    t_train: int = 101,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate: float = 1e-3,
    learning_rate_share: float = 1e-3,
    learning_rate_fc2: float = 1e-3,
    scheduler: str = "cosine",
    scheduler_step: int = 100,
    scheduler_gamma: float = 0.5,
    training_type: str = "single",
    if_training: bool = True,
    iLow: int = 4,
    iHigh: int = 12,
    plot: bool = False,
    channel_plot: int = 0,
    model_update: int = 1,
    seed: int = 16,
    run_dir: str = "runs/fno",
    model_name: str = "fno2d_dr",
    continue_training: bool = False,
    log_every: int = 50,
    shard_store: bool = False,
    host_stream: bool = False,
    resident_rotate: int = 0,
    dr_leaky_clip: bool = False,
    resident_rotate_schedule: str = "block",
    init_params: dict | None = None,
    fast_step: bool | None = None,
    device=None,
) -> FNOTrainResult:
    """Train an FNO from the HDF5 files of ``dataset_family``, or evaluate
    one (``if_training=False``).  Defaults are JAX's.

      ``dr``    ``base_path``/2D_diff-react_test_all.h5 (``extra_train_files``
                beside it continue the train pool); with ``if_aux`` the aux
                trajectories from ``aux_path`` (``aux_file``, or the
                decomposed file, or with ``if_downsample`` its downsampled
                copy, upsampled on load).
      ``ns``    ``{sim_name}-{i}.h5`` (test files ``test_range``), with
                ``if_aux`` the aux files ``{aux_name}-{i}.h5`` paired per
                file (``data/ns.py``); ``primary_store_dtype`` and
                ``aux_store_dtype`` ``"bf16"`` keep the train stores in
                bf16, ``aux_upsample_at_gather`` keeps an aux store of
                another resolution at its own (the step upsamples), and
                ``aux_native_compute`` then runs the aux stream there.
      ``ns3d``  the plume seeds (``data/ns3d.py``; test seeds
                ``range(*test_range)``): the 3D FNO, or with
                ``model_family="transformer3d"`` the 3D VideoMAE operator
                (``transformer_kwargs``: patch, tubelet, widths, depths,
                heads, drop-path rate, ``use_checkpoint``).

    ``train_subsample`` = (baseline, aux primary, aux) counts.  The
    evaluation reads the test split alone.  A configuration that cannot run
    raises before any data is read; ``channel_plot`` goes with ``plot``."""
    resident_rotate = int(resident_rotate or 0)
    check_placement(epochs=epochs, host_stream=host_stream, shard_store=shard_store,
                    resident_rotate=resident_rotate,
                    resident_rotate_schedule=resident_rotate_schedule, aux_chunks=aux_chunks,
                    aux_upsample_at_gather=aux_upsample_at_gather,
                    aux_native_compute=aux_native_compute)
    select_fast_step(fast_step, if_aux=if_aux, model_family=model_family,
                     training_type=training_type, rollout_test=rollout_test,
                     lie_augment=lie_augment, shard_store=shard_store, host_stream=host_stream,
                     resident_rotate=resident_rotate, scheduler=scheduler,
                     n_data=make_mesh().shape["data"])  # an explicit True raises here
    if dataset_family not in _FAMILIES:
        raise ValueError(f"unknown dataset_family {dataset_family!r}; one of {_FAMILIES}")
    if model_family not in _FAMILIES_MODEL:
        raise ValueError(f"unknown model_family {model_family!r}; one of {_FAMILIES_MODEL}")
    if model_family == "transformer3d" and dataset_family != "ns3d":
        raise ValueError("model_family='transformer3d' trains on the 3D plume (dataset_family "
                         "'ns3d')")
    if transformer_kwargs is not None and model_family != "transformer3d":
        raise ValueError("transformer_kwargs goes with model_family='transformer3d'")
    if dataset_family == "dr":
        # the DR loaders take none of these (JAX ignores them there)
        ns_only = {"aux_store_dtype": aux_store_dtype is not None,
                   "primary_store_dtype": primary_store_dtype is not None,
                   "aux_upsample_at_gather": aux_upsample_at_gather}
        given = [k for k, on in ns_only.items() if on]
        if given:
            raise ValueError(f"{', '.join(given)}: NS-family store options; the DR stores "
                             "stay f32 at the primary resolution")
    dev = resolve_device(device)
    common = dict(modes=modes, width=width, batch_size=batch_size, run_dir=run_dir,
                  model_name=model_name, model_family=model_family,
                  transformer_kwargs=transformer_kwargs, device=dev)
    windows = dict(initial_step=initial_step, rollout_test=rollout_test, device=dev)
    if not if_training:
        if dataset_family == "ns":
            test = load_ns_test(base_path, sim_name=sim_name, test_range=test_range, **windows)
        elif dataset_family == "ns3d":
            test = load_ns3d_test(base_path, test_seeds=range(*test_range), **windows)
        else:
            test = load_dr_test(base_path, **windows)
        return evaluate_checkpoint(test, if_aux=if_aux, rollout_test=rollout_test, iLow=iLow,
                                   iHigh=iHigh, plot=plot, channel_plot=channel_plot, **common)
    fit = dict(initial_step=initial_step, num_channels=num_channels, epochs=epochs,
               scheduler=scheduler, scheduler_step=scheduler_step,
               scheduler_gamma=scheduler_gamma, fno_remat=fno_remat,
               model_update=model_update, seed=seed, continue_training=continue_training,
               log_every=log_every, init_params=init_params, host_stream=host_stream,
               resident_rotate=resident_rotate,
               resident_rotate_schedule=resident_rotate_schedule, shard_store=shard_store,
               **common)
    # the train stores stay in host RAM where a slice, a shard or a stream of
    # batches goes to the device instead; the test store goes there
    windows["to_device"] = not (host_stream or resident_rotate > 1 or shard_store)
    if if_aux:
        sub = tuple(train_subsample)
        if dataset_family == "ns":
            ds = load_ns_aux(base_path, aux_path, train_subsample=sub,
                             num_aux_samples=num_aux_samples, sim_name=sim_name,
                             aux_name=aux_name, if_downsample=if_downsample,
                             test_range=test_range, aux_store_dtype=aux_store_dtype,
                             store_dtype=primary_store_dtype,
                             aux_upsample_at_gather=aux_upsample_at_gather, **windows)
        elif dataset_family == "ns3d":
            ds = load_ns3d_aux(base_path, aux_path, train_subsample=sub,
                               num_aux_samples=num_aux_samples,
                               test_seeds=range(*test_range), aux_store_dtype=aux_store_dtype,
                               store_dtype=primary_store_dtype, **windows)
        else:
            ds = load_dr_aux(base_path, aux_path, train_subsample=sub,
                             num_aux_samples=num_aux_samples, if_downsample=if_downsample,
                             extra_train_files=extra_train_files, aux_file=aux_file, **windows)
        return train_aux(ds, learning_rate_share=learning_rate_share,
                         learning_rate_fc2=learning_rate_fc2, num_aux_samples=num_aux_samples,
                         auxiliary_weight=auxiliary_weight, aux_chunks=aux_chunks,
                         aux_native_compute=aux_native_compute, **fit)
    sub = train_subsample[0] if isinstance(train_subsample, (list, tuple)) else train_subsample
    if dataset_family == "ns":
        ds = load_ns_baseline(base_path, train_subsample=sub, sim_name=sim_name,
                              test_range=test_range, store_dtype=primary_store_dtype,
                              **windows)
    elif dataset_family == "ns3d":
        d3 = load_ns3d_aux(base_path, aux_path, train_subsample=tuple(train_subsample),
                           num_aux_samples=num_aux_samples, test_seeds=range(*test_range),
                           with_aux=False, store_dtype=primary_store_dtype, **windows)
        ds = NSBaselineDataset(train=d3.primary_train, test=d3.primary_test)
    else:
        ds = load_dr_baseline(base_path, train_subsample=sub,
                              extra_train_files=extra_train_files, leaky_clip=dr_leaky_clip,
                              **windows)
    return train_baseline(ds, learning_rate=learning_rate, training_type=training_type,
                          t_train=t_train, lie_augment=lie_augment, fast_step=fast_step, **fit)
