"""OFormer / Hyena-hybrid training and evaluation on 2D diffusion-reaction
(port of ``sciml_pde_tpu/comparisons/oformer_dr2d.py``).

Grid fields are flattened to point sets with unit-square coordinates and
the model predicts the next frame pointwise (``run_comparison_training``,
``evaluate_comparison``: relative L2 per step of an autoregressive rollout
and the accumulated MSE).  ``run_rollout_protocol`` is the reference's DR
study: a 64x64 single-channel OFormer (or the Hyena hybrid) encodes the
first ``in_seq_len`` frames once and decodes ``out_seq_len`` frames through
the latent propagator (``remat``: each step recomputed in the backward
pass), on inputs and targets standardised by the train statistics, and
``evaluate_rollout_protocol`` reports the reference's five numbers.

The data come through the port's ``data/dr.py`` and ``data/windows.py``,
shuffled by the same ``np.random.default_rng(seed)`` draws as the JAX
package's; the optimizer is optax's chain ``clip_by_global_norm(1.0)`` ->
``adamw(cosine_decay_schedule)`` (``train/optim.py::AdamW``).  The models
start from a flax tree where ``init_params`` gives one (a JAX ``init``
drives the port), else from the port's own seeded initialisation; the
results carry the trained tree in flax's layout (numpy).  Everything runs
on ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.dr import load_dr_baseline
from sciml_pde_torch.data.windows import epoch_batches, gather_windows
from sciml_pde_torch.models.hyena import HyenaOFormer2D
from sciml_pde_torch.models.oformer import OFormer2D
from sciml_pde_torch.train.optim import AdamW, make_lr_schedule
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import oformer_flax_to_state_dict, oformer_state_dict_to_flax


def rel_l2(pred: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    n = pred.shape[0]
    d = torch.linalg.vector_norm(pred.reshape(n, -1) - tgt.reshape(n, -1), dim=1)
    return torch.mean(d / (eps + torch.linalg.vector_norm(tgt.reshape(n, -1), dim=1)))


def _flatten_window(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, T, C) -> points (B, N, T*C)."""
    b, nx, ny, t, c = x.shape
    return x.reshape(b, nx * ny, t * c)


def _pos_for(grid: torch.Tensor, b: int) -> torch.Tensor:
    nx, ny, _ = grid.shape
    return grid.reshape(1, nx * ny, 2).expand(b, nx * ny, 2)


def start_model(model: torch.nn.Module, init_params, device) -> torch.nn.Module:
    """``model`` with the flax tree ``init_params`` loaded (if given), on
    ``device``."""
    if init_params is not None:
        model.load_state_dict(oformer_flax_to_state_dict(init_params))
    return model.to(device)


def grads_of(loss: torch.Tensor, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """d loss / d every parameter; zeros for the ones the loss reads through
    ``detach`` (the Fourier features' ``B``), which the optimizer still
    decays, as optax decays a ``stop_gradient`` leaf."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), gs)}


def trained_tree(model: torch.nn.Module) -> dict:
    """The model's parameters as a flax tree of numpy arrays."""
    return oformer_state_dict_to_flax(model.state_dict())


@dataclasses.dataclass
class ComparisonResult:
    params: object
    history: list
    model: object = None
    test_w: object = None


def run_comparison_training(
    *,
    base_path: str,
    model_type: str = "oformer",  # oformer | hyena
    dataset_family: str = "dr",  # dr | ns
    train_subsample: int = 4,
    initial_step: int = 10,
    num_channels: int = 2,
    batch_size: int = 4,
    epochs: int = 10,
    learning_rate: float = 3e-4,
    in_emb_dim: int = 96,
    latent_channels: int = 192,
    heads: int = 4,
    depth: int = 2,
    test_range=(250, 275),
    run_dir: str = "runs/comparison",
    model_name: str = "oformer_dr",
    log_every: int = 100,
    seed: int = 16,
    init_params=None,
    device=None,
) -> ComparisonResult:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    logger = MetricLogger(run_dir, name=model_name)
    if dataset_family == "ns":
        from sciml_pde_torch.data.ns import load_ns_baseline

        ds = load_ns_baseline(base_path, train_subsample=train_subsample,
                              initial_step=initial_step, rollout_test=1,
                              test_range=test_range, device=dev)
    else:
        ds = load_dr_baseline(base_path, train_subsample=train_subsample,
                              initial_step=initial_step, rollout_test=1, device=dev)
    train_w, test_w = ds.train, ds.test
    cin = initial_step * num_channels + 2  # window + coordinates
    n_tokens = int(np.prod(train_w.data.shape[2:4]))
    gen = torch.Generator().manual_seed(seed)
    if model_type == "hyena":
        model = HyenaOFormer2D(cin, num_channels, in_emb_dim, latent_channels, heads, depth,
                               branches=8, l_max=n_tokens, generator=gen)
    else:
        model = OFormer2D(cin, num_channels, in_emb_dim, latent_channels, heads, depth,
                          out_steps=1, propagator_depth=1, generator=gen)
    model = start_model(model, init_params, dev)
    params = dict(model.named_parameters())

    train_idx = train_w.window_index()
    opt = AdamW(params, make_lr_schedule(
        "cosine", learning_rate, max(epochs * (len(train_idx) // batch_size), 1)), clip=1.0)
    grid = train_w.grid

    def step(idx):
        x, y = gather_windows(train_w.data, idx, initial_step, 1)
        pts = _flatten_window(x)
        pos = _pos_for(grid, pts.shape[0])
        yf = y[..., 0, :].reshape(y.shape[0], -1, y.shape[-1])
        loss = rel_l2(model(torch.cat([pts, pos], dim=-1), pos), yf)
        opt.step(params, grads_of(loss, params))
        return loss.detach()

    history = []
    gstep = 0
    for ep in range(epochs):
        for batch in epoch_batches(train_idx, batch_size, rng):
            loss = step(torch.as_tensor(batch, dtype=torch.long, device=dev))
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, train_rel_l2=float(loss), epoch=ep)
        history.append({"epoch": ep, "train_rel_l2": float(loss)})
    return ComparisonResult(params=trained_tree(model), history=history, model=model,
                            test_w=test_w)


@torch.no_grad()
def evaluate_comparison(model, params, test_w, initial_step: int, rollout_steps: int,
                        batch_size: int = 4) -> dict:
    """Autoregressive rollout metrics (``params``: a flax tree to load into
    ``model`` first, or None for its own weights)."""
    if params is not None:
        model.load_state_dict(oformer_flax_to_state_dict(params))
    dev = test_w.data.device
    model = model.to(dev)
    idx = test_w.window_index()
    grid = test_w.grid
    nx, ny, _ = grid.shape
    c = test_w.data.shape[-1]

    per_step_rel, mses = [], []
    for b0 in range(0, len(idx), batch_size):
        chunk = torch.as_tensor(idx[b0:b0 + batch_size], dtype=torch.long, device=dev)
        x, y = gather_windows(test_w.data, chunk, initial_step, rollout_steps)
        b = x.shape[0]
        pos = _pos_for(grid, b)
        preds = []
        for _ in range(rollout_steps):
            pred_pts = model(torch.cat([_flatten_window(x), pos], dim=-1), pos)
            x = torch.cat([x[..., 1:, :], pred_pts.reshape(b, nx, ny, 1, c)], dim=-2)
            preds.append(pred_pts)
        preds = torch.stack(preds)
        tgt = torch.movedim(y, -2, 0).reshape(rollout_steps, -1, nx * ny, c)
        for t in range(rollout_steps):
            per_step_rel.append((t, float(rel_l2(preds[t], tgt[t]))))
        mses.append(float(torch.mean((preds - tgt) ** 2)))

    steps: dict = {}
    for t, v in per_step_rel:
        steps.setdefault(t, []).append(v)
    rel_by_step = [float(np.mean(steps[t])) for t in sorted(steps)]
    return {
        "rel_l2_by_step": rel_by_step,
        "rollout_rel_l2": float(np.mean(rel_by_step)),
        "final_rel_l2": rel_by_step[-1],
        "accumulated_mse": float(np.mean(mses)),
    }


# --------------------------------------------------------------------------
# the reference protocol: one encode, a long latent rollout
# --------------------------------------------------------------------------


def _protocol_arrays(base_path, *, train_subsample, extra_train_files,
                     in_seq_len, out_seq_len, spatial_down, channel):
    """The DR pool shaped into protocol arrays (float32 numpy):
      x_train/x_test (N, n_tokens, in_seq_len*C) normalised inputs,
      y_train (N, out_seq_len, n_tokens, C) normalised targets,
      y_test_raw the raw test targets, pos (n_tokens, 2), and the stats."""
    from sciml_pde_torch.data.dr import PRIMARY_FILE, _load_train_pool

    train, test, grid = _load_train_pool(
        Path(base_path), PRIMARY_FILE, train_subsample, extra_train_files)
    d = spatial_down
    out = {}
    for name, arr in (("train", train), ("test", test)):
        a = np.asarray(arr)[:, : in_seq_len + out_seq_len, ::d, ::d, :]
        if channel is not None:
            a = a[..., channel:channel + 1]
        n, _, h, w, c = a.shape
        x = np.moveaxis(a[:, :in_seq_len], 1, 3).reshape(n, h * w, in_seq_len * c)
        y = a[:, in_seq_len:].reshape(n, out_seq_len, h * w, c)
        out[name] = (x.astype(np.float32), y.astype(np.float32))
    (x_tr, y_tr), (x_te, y_te) = out["train"], out["test"]
    stats = {
        "x_mean": float(x_tr.mean()), "x_std": float(x_tr.std() + 1e-8),
        "y_mean": float(y_tr.mean()), "y_std": float(y_tr.std() + 1e-8),
    }
    g = np.asarray(grid)[::d, ::d].reshape(-1, 2).astype(np.float32)
    return {
        "x_train": (x_tr - stats["x_mean"]) / stats["x_std"],
        "y_train": (y_tr - stats["y_mean"]) / stats["y_std"],
        "x_test": (x_te - stats["x_mean"]) / stats["x_std"],
        "y_test_raw": y_te,
        "pos": g, **stats,
    }


def protocol_model(model_type: str, cin_pts: int, c_out: int, n_tokens: int, *,
                   in_emb_dim: int = 96, latent_channels: int = 192, heads: int = 4,
                   depth: int = 2, propagator_depth: int = 1, generator=None):
    """The protocol's model (``remat`` on): input the window's channels and
    the two coordinates."""
    kw = dict(in_emb_dim=in_emb_dim, latent_channels=latent_channels, heads=heads,
              depth=depth, out_steps=1, remat=True, generator=generator)
    if model_type == "hyena":
        return HyenaOFormer2D(cin_pts + 2, c_out, branches=8, l_max=n_tokens, **kw)
    return OFormer2D(cin_pts + 2, c_out, propagator_depth=propagator_depth, **kw)


def protocol_rollout(model, xb, pos1, out_seq_len: int, c_out: int) -> torch.Tensor:
    """(b, n, t*C) inputs -> (b, t, n, C) predictions through the latent
    rollout."""
    b, n_tokens = xb.shape[0], xb.shape[1]
    pp = pos1[None].expand(b, n_tokens, 2)
    pred = model.rollout(torch.cat([xb, pp], dim=-1), pp, out_seq_len)
    return torch.movedim(pred.reshape(b, n_tokens, out_seq_len, c_out), 2, 1)


def protocol_step(model, opt, pos1, out_seq_len: int, c_out: int):
    """The protocol's training step: ``step(xb, yb)`` rolls ``model`` out
    over ``out_seq_len`` frames, takes the relative L2 against ``yb``,
    applies ``opt`` to the model's parameters and returns the loss."""
    params = dict(model.named_parameters())

    def step(xb, yb):
        loss = rel_l2(protocol_rollout(model, xb, pos1, out_seq_len, c_out), yb)
        opt.step(params, grads_of(loss, params))
        return loss.detach()
    return step


def run_rollout_protocol(
    *,
    base_path: str,
    model_type: str = "oformer",  # oformer | hyena
    in_seq_len: int = 10,
    out_seq_len: int = 40,
    spatial_down: int = 2,        # 128 -> 64 grid, the reference resolution
    channel: int | None = 0,      # the reference trains the activator channel
    train_subsample=270,
    extra_train_files: list[str] | None = None,
    batch_size: int = 4,
    epochs: int = 100,
    learning_rate: float = 3e-4,
    in_emb_dim: int = 96,
    latent_channels: int = 192,
    heads: int = 4,
    depth: int = 2,
    propagator_depth: int = 1,
    run_dir: str = "runs/comparison",
    model_name: str = "oformer_dr_rollout",
    log_every: int = 20,
    seed: int = 16,
    init_params=None,
    device=None,
):
    """Train and evaluate one model under the reference rollout protocol.
    Returns (metrics dict, params as a flax tree); the metrics carry the
    reference's five numbers and ``train_rel_l2_final``."""
    dev = resolve_device(device)
    logger = MetricLogger(run_dir, name=model_name)
    rng = np.random.default_rng(seed)
    arrs = _protocol_arrays(
        base_path, train_subsample=train_subsample,
        extra_train_files=extra_train_files, in_seq_len=in_seq_len,
        out_seq_len=out_seq_len, spatial_down=spatial_down, channel=channel)
    x_tr = torch.as_tensor(arrs["x_train"], device=dev)
    y_tr = torch.as_tensor(arrs["y_train"], device=dev)
    n_tokens, cin_pts = x_tr.shape[1], x_tr.shape[2]
    c_out = y_tr.shape[-1]
    pos1 = torch.as_tensor(arrs["pos"], device=dev)

    model = protocol_model(model_type, cin_pts, c_out, n_tokens, in_emb_dim=in_emb_dim,
                           latent_channels=latent_channels, heads=heads, depth=depth,
                           propagator_depth=propagator_depth,
                           generator=torch.Generator().manual_seed(seed))
    model = start_model(model, init_params, dev)
    params = dict(model.named_parameters())
    n_train = int(x_tr.shape[0])
    steps_per_epoch = max(n_train // batch_size, 1)
    opt = AdamW(params, make_lr_schedule("cosine", learning_rate,
                                         max(epochs * steps_per_epoch, 1)), clip=1.0)

    step = protocol_step(model, opt, pos1, out_seq_len, c_out)
    gstep = 0
    history = []
    for ep in range(epochs):
        order = rng.permutation(n_train)
        for s in range(steps_per_epoch):
            rows = torch.as_tensor(order[s * batch_size:(s + 1) * batch_size], device=dev)
            loss = step(x_tr[rows], y_tr[rows])
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, train_rel_l2=float(loss), epoch=ep)
        history.append(float(loss))

    metrics = evaluate_rollout_protocol(model, None, arrs, out_seq_len=out_seq_len,
                                        batch_size=batch_size)
    metrics["train_rel_l2_final"] = history[-1]
    return metrics, trained_tree(model)


@torch.no_grad()
def evaluate_rollout_protocol(model, params, arrs, *, out_seq_len, batch_size=4):
    """The reference's five evaluation numbers: predictions de-normalised
    with the train y-statistics against the raw targets.  ``params``: a flax
    tree to load into ``model`` first, or None for its own weights."""
    if params is not None:
        model.load_state_dict(oformer_flax_to_state_dict(params))
    dev = next(model.parameters()).device
    x_te = torch.as_tensor(arrs["x_test"], device=dev)
    y_te = arrs["y_test_raw"]  # (N, t, n, c) raw units
    pos1 = torch.as_tensor(arrs["pos"], device=dev)
    c_out = y_te.shape[-1]
    y_mean, y_std = arrs["y_mean"], arrs["y_std"]

    def nrmse(pred, tgt):
        # per (sample, frame): rmse over tokens / target range over tokens
        ax = tuple(range(2, pred.ndim))
        rmse = np.sqrt(((pred - tgt) ** 2).mean(axis=ax) + 1e-12)
        rng_ = np.maximum(tgt.max(axis=ax) - tgt.min(axis=ax), 1e-12)
        return float((rmse / rng_).mean())

    def rel(a, b):
        return float(rel_l2(torch.as_tensor(a), torch.as_tensor(b)))

    rel_all, mse_all, rel_last, nr_all, nr_last = [], [], [], [], []
    for b0 in range(0, x_te.shape[0], batch_size):
        pred = protocol_rollout(model, x_te[b0:b0 + batch_size], pos1, out_seq_len, c_out)
        pred = (pred * y_std + y_mean).cpu().numpy()
        tgt = y_te[b0:b0 + batch_size]
        rel_all.append(rel(pred, tgt))
        mse_all.append(float(((pred - tgt) ** 2).sum()
                             / (pred.shape[0] * pred.shape[2] * pred.shape[3])))
        rel_last.append(rel(pred[:, -1:], tgt[:, -1:]))
        nr_all.append(nrmse(pred, tgt))
        nr_last.append(nrmse(pred[:, -1:], tgt[:, -1:]))
    return {
        "avg_rel_l2": float(np.mean(rel_all)),
        "accumulated_mse": float(np.mean(mse_all)),
        "final_rel_l2": float(np.mean(rel_last)),
        "nrmse_rollout": float(np.mean(nr_all)),
        "nrmse_final": float(np.mean(nr_last)),
    }
