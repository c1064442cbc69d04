"""Generic OFormer training on PDEBench-format datasets, Burgers and Darcy
(port of ``sciml_pde_tpu/comparisons/oformer_generic.py``).

PDEBench 1D HDF5 arrays (keyed ``tensor``/``u``/``data``) are windowed into
(input frames, next frame) pairs over the flattened points with their
coordinates; Darcy maps the coefficient a(x) to the solution u(x) on a 2D
grid.  Training minimises relative L2 with optax's ``adamw`` on a cosine
decay (``train/optim.py::AdamW``), shuffled by the JAX package's
``np.random.default_rng(seed)`` draws.  Files are read through
``io/h5.py::h5py_module`` (h5py where installed, else the port's own
reader), imported inside the functions.  ``init_params``: a flax tree to
start from (else the port's seeded initialisation); the results carry the
trained tree in flax's layout.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.comparisons.oformer_dr2d import (
    grads_of,
    rel_l2,
    start_model,
    trained_tree,
)
from sciml_pde_torch.models.oformer import OFormer1D, OFormer2D
from sciml_pde_torch.train.optim import AdamW, make_lr_schedule
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import oformer_flax_to_state_dict


def load_pdebench_1d(path: str | Path, field_keys=("tensor", "u", "data")) -> np.ndarray:
    """PDEBench 1D file -> (N, T, X) float32."""
    from sciml_pde_torch.io.h5 import h5py_module

    with h5py_module().File(path, "r") as f:
        for k in field_keys:
            if k in f:
                return np.asarray(f[k], dtype=np.float32)
        raise KeyError(f"none of {field_keys} in {path}: has {list(f)}")


@dataclasses.dataclass
class Generic1DResult:
    params: object
    history: list
    norm_stats: tuple | None = None


def _make_burgers_model(initial_step=10, in_emb_dim=64, depth=3, heads=4, generator=None):
    return OFormer1D(initial_step + 1, 1, in_emb_dim=in_emb_dim, latent_channels=in_emb_dim,
                     heads=heads, depth=depth, out_steps=1, generator=generator)


def _make_darcy_model(in_emb_dim=64, depth=3, heads=4, generator=None):
    return OFormer2D(3, 1, in_emb_dim=in_emb_dim, latent_channels=in_emb_dim, heads=heads,
                     depth=depth, out_steps=1, propagator_depth=1, generator=generator)


def _windows_index(n: int, t: int, initial_step: int) -> np.ndarray:
    return np.stack([np.repeat(np.arange(n), t - initial_step),
                     np.tile(np.arange(t - initial_step), n)], axis=1).astype(np.int32)


def _burgers_batch(darr, pos, b_idx, initial_step: int):
    """Windows of rows (trajectory, t0): inputs (B, X, initial_step + 1)
    (the frames, then the coordinate), coordinates (B, X, 1), targets
    (B, X, 1)."""
    frames = b_idx[:, 1, None] + torch.arange(initial_step + 1, device=b_idx.device)
    win = darr[b_idx[:, 0, None], frames]  # (B, s + 1, X)
    x = win[:, :initial_step].transpose(1, 2)
    p = pos.expand(x.shape[0], -1, 1)
    return torch.cat([x, p], dim=-1), p, win[:, initial_step, :, None]


def supervised_step(model, opt):
    """The Burgers and Darcy training step: ``step(inp, pos, y)`` takes the
    relative L2 of ``model(inp, pos)`` against ``y``, applies ``opt`` to the
    model's parameters and returns the loss."""
    params = dict(model.named_parameters())

    def step(inp, pos, y):
        loss = rel_l2(model(inp, pos), y)
        opt.step(params, grads_of(loss, params))
        return loss.detach()
    return step


def _line(nx: int, dev) -> torch.Tensor:
    """(1, X, 1) coordinates: numpy's f32 linspace, as the JAX package's."""
    return torch.as_tensor(np.linspace(0, 1, nx, dtype=np.float32), device=dev)[None, :, None]


def _darcy_grid(nx: int, ny: int) -> np.ndarray:
    gx, gy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    return np.stack([gx, gy], -1).reshape(1, nx * ny, 2).astype(np.float32)


def run_oformer_burgers(
    data: np.ndarray,  # (N, T, X)
    initial_step: int = 10,
    batch_size: int = 8,
    epochs: int = 5,
    learning_rate: float = 3e-4,
    in_emb_dim: int = 64,
    depth: int = 3,
    heads: int = 4,
    run_dir: str = "runs/oformer_burgers",
    seed: int = 16,
    log_every: int = 200,
    init_params=None,
    device=None,
) -> Generic1DResult:
    """Next-step operator training on 1D trajectories."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    logger = MetricLogger(run_dir, name="oformer_burgers")
    n, t, nx = data.shape
    pos = _line(nx, dev)
    model = start_model(_make_burgers_model(initial_step, in_emb_dim, depth, heads,
                                            torch.Generator().manual_seed(seed)),
                        init_params, dev)
    params = dict(model.named_parameters())
    idx = _windows_index(n, t, initial_step)
    darr = torch.as_tensor(data, dtype=torch.float32, device=dev)
    opt = AdamW(params, make_lr_schedule("cosine", learning_rate,
                                         max(epochs * (len(idx) // batch_size), 1)))

    step = supervised_step(model, opt)
    history, gstep = [], 0
    for ep in range(epochs):
        order = rng.permutation(len(idx))
        for b in range(0, len(idx) - batch_size + 1, batch_size):
            b_idx = torch.as_tensor(idx[order[b:b + batch_size]], dtype=torch.long, device=dev)
            loss = step(*_burgers_batch(darr, pos, b_idx, initial_step))
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, rel_l2=float(loss), epoch=ep)
        history.append({"epoch": ep, "rel_l2": float(loss)})
    return Generic1DResult(params=trained_tree(model), history=history)


def run_oformer_darcy(
    a_field: np.ndarray,  # (N, X, Y) coefficient
    u_field: np.ndarray,  # (N, X, Y) solution
    batch_size: int = 4,
    epochs: int = 5,
    learning_rate: float = 3e-4,
    in_emb_dim: int = 64,
    depth: int = 3,
    heads: int = 4,
    run_dir: str = "runs/oformer_darcy",
    seed: int = 16,
    init_params=None,
    device=None,
) -> Generic1DResult:
    """Steady-state operator a(x) -> u(x) on a 2D grid.  Inputs are
    standardised with the train statistics; the stats ride along in
    ``result.norm_stats`` for held-out evaluation."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, nx, ny = a_field.shape
    model = start_model(_make_darcy_model(in_emb_dim, depth, heads,
                                          torch.Generator().manual_seed(seed)),
                        init_params, dev)
    params = dict(model.named_parameters())
    a_mean, a_std = float(a_field.mean()), float(a_field.std()) + 1e-12
    u_scale = float(np.abs(u_field).mean()) + 1e-12
    a_flat = torch.as_tensor((a_field.reshape(n, nx * ny, 1) - a_mean) / a_std,
                             dtype=torch.float32, device=dev)
    u_flat = torch.as_tensor(u_field.reshape(n, nx * ny, 1) / u_scale, dtype=torch.float32,
                             device=dev)
    parr = torch.as_tensor(_darcy_grid(nx, ny), device=dev)
    opt = AdamW(params, make_lr_schedule("cosine", learning_rate,
                                         max(epochs * (n // batch_size), 1)))

    step = supervised_step(model, opt)
    history = []
    for ep in range(epochs):
        order = rng.permutation(n)
        for b in range(0, n - batch_size + 1, batch_size):
            rows = torch.as_tensor(order[b:b + batch_size], device=dev)
            p = parr.expand(len(rows), nx * ny, 2)
            loss = step(torch.cat([a_flat[rows], p], dim=-1), p, u_flat[rows])
        history.append({"epoch": ep, "rel_l2": float(loss)})
    return Generic1DResult(params=trained_tree(model), history=history,
                           norm_stats=(a_mean, a_std, u_scale))


# ---------------------------------------------------------------- held-out eval


@torch.no_grad()
def eval_oformer_burgers(
    params, data: np.ndarray, initial_step: int = 10, batch_size: int = 32,
    in_emb_dim: int = 64, depth: int = 3, heads: int = 4, device=None,
) -> float:
    """Mean next-step rel-L2 over all windows of held-out trajectories."""
    dev = resolve_device(device)
    model = _make_burgers_model(initial_step, in_emb_dim, depth, heads)
    model.load_state_dict(oformer_flax_to_state_dict(params))
    model = model.to(dev)
    n, t, nx = data.shape
    pos = _line(nx, dev)
    darr = torch.as_tensor(data, dtype=torch.float32, device=dev)
    idx = _windows_index(n, t, initial_step)
    tot, nb = 0.0, 0
    for b in range(0, len(idx) - batch_size + 1, batch_size):
        b_idx = torch.as_tensor(idx[b:b + batch_size], dtype=torch.long, device=dev)
        inp, p, y = _burgers_batch(darr, pos, b_idx, initial_step)
        tot += float(rel_l2(model(inp, p), y))
        nb += 1
    return tot / max(nb, 1)


@torch.no_grad()
def eval_oformer_darcy(
    params, a_field: np.ndarray, u_field: np.ndarray, batch_size: int = 8,
    in_emb_dim: int = 64, depth: int = 3, heads: int = 4,
    norm_stats: tuple | None = None, device=None,
) -> float:
    dev = resolve_device(device)
    model = _make_darcy_model(in_emb_dim, depth, heads)
    model.load_state_dict(oformer_flax_to_state_dict(params))
    model = model.to(dev)
    n, nx, ny = a_field.shape
    pos = torch.as_tensor(_darcy_grid(nx, ny), device=dev)
    a_mean, a_std, u_scale = norm_stats if norm_stats else (0.0, 1.0, 1.0)
    a_flat = torch.as_tensor((a_field.reshape(n, nx * ny, 1) - a_mean) / a_std,
                             dtype=torch.float32, device=dev)
    # rel-L2 is invariant to the constant u scale, but the model predicts in
    # scaled units, so the target is scaled the same way
    u_flat = torch.as_tensor(u_field.reshape(n, nx * ny, 1) / u_scale, dtype=torch.float32,
                             device=dev)
    tot, nb = 0.0, 0
    for b in range(0, n, batch_size):
        rows = torch.arange(b, min(b + batch_size, n), device=dev)
        p = pos.expand(len(rows), nx * ny, 2)
        tot += float(rel_l2(model(torch.cat([a_flat[rows], p], dim=-1), p), u_flat[rows]))
        nb += 1
    return tot / max(nb, 1)
