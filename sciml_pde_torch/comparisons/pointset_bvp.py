"""Irregular point-set BVP and airfoil-class training (port of
``sciml_pde_tpu/comparisons/pointset_bvp.py``).

Variable-size scattered node sets arrive zero-padded with pad masks; the
model is the pad-aware irregular encoder/decoder
(``models/oformer.py::OFormerIrreg2D``), the loss the masked pointwise loss
over the scalar (potential) head plus the field head.  The synthetic
generators (random point charges with a grounded boundary; advecting
Gaussian vortices on fixed scattered nodes) and ``standardize_features``
are the JAX package's numpy code, so they give the same arrays bit for
bit.  ``run_pointset_training(reference_recipe=True)`` is the BVP suite's
recipe: warmup-cosine, clip 2.0, weight decay 1e-4 added to the gradient,
then AMSGrad (``train/optim.py::AMSGrad``), squared loss with field weight
1.0; otherwise optax ``adamw`` on a cosine decay.  ``run_airfoil_training``
trains the time-dependent point-set operator (``OFormerIrregST2D``).
``init_params``: a flax tree to start from (else the port's seeded
initialisation); the results carry the trained tree in flax's layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.comparisons.oformer_dr2d import grads_of, start_model, trained_tree
from sciml_pde_torch.models.oformer import OFormerIrreg2D, OFormerIrregST2D
from sciml_pde_torch.train.optim import (
    AdamW,
    AMSGrad,
    make_lr_schedule,
    warmup_cosine_decay_schedule,
)
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import oformer_flax_to_state_dict


def synthetic_electrostatics(
    seed: int,
    n_samples: int,
    max_points: int = 128,
    n_charges: int = 4,
    min_points: int | None = None,
):
    """Random point-charge BVPs on scattered nodes.

    Returns dict of arrays:
      features (N, P, 3*n_charges): per node, (dx, dy, q) to each charge
      coords   (N, P, 2), pad_mask (N, P) bool, bound_mask (N, P) bool
      scalar   (N, P, 1) potential;  field (N, P, 2) = -grad(potential)
    Node counts vary per sample (pad rows zeroed), boundary nodes sit on
    the unit-square edge with the potential clamped to 0 (grounded).
    """
    rng = np.random.default_rng(seed)
    min_points = min_points or max_points // 2
    feats = np.zeros((n_samples, max_points, 3 * n_charges), np.float32)
    coords = np.zeros((n_samples, max_points, 2), np.float32)
    pad = np.zeros((n_samples, max_points), bool)
    bound = np.zeros((n_samples, max_points), bool)
    phi = np.zeros((n_samples, max_points, 1), np.float32)
    efield = np.zeros((n_samples, max_points, 2), np.float32)

    for s in range(n_samples):
        n_pts = int(rng.integers(min_points, max_points + 1))
        n_bnd = max(n_pts // 8, 4)
        inner = rng.uniform(0.05, 0.95, size=(n_pts - n_bnd, 2))
        t = rng.uniform(0, 4, size=n_bnd)
        side, frac = np.floor(t).astype(int), t - np.floor(t)
        bx = np.where(side == 0, frac, np.where(side == 1, 1.0, np.where(side == 2, 1 - frac, 0.0)))
        by = np.where(side == 0, 0.0, np.where(side == 1, frac, np.where(side == 2, 1.0, 1 - frac)))
        pts = np.concatenate([inner, np.stack([bx, by], 1)])

        q = rng.uniform(-1, 1, size=n_charges)
        cpos = rng.uniform(0.2, 0.8, size=(n_charges, 2))
        d = pts[:, None, :] - cpos[None, :, :]  # (P, K, 2)
        r2 = np.maximum((d ** 2).sum(-1), 1e-3)
        # phi = -sum q log r  (2D free-space Green's function, sign conv.)
        p = -(q[None] * 0.5 * np.log(r2)).sum(-1)
        e = (q[None, :, None] * d / r2[..., None]).sum(1)  # E = -grad phi

        coords[s, :n_pts] = pts
        feats[s, :n_pts] = np.concatenate(
            [d.reshape(n_pts, -1), np.broadcast_to(q, (n_pts, n_charges))], 1
        )[:, : 3 * n_charges]
        pad[s, :n_pts] = True
        bound[s, n_pts - n_bnd : n_pts] = True
        phi[s, :n_pts, 0] = p
        efield[s, :n_pts] = e

    return dict(features=feats, coords=coords, pad_mask=pad,
                bound_mask=bound, scalar=phi, field=efield)


def standardize_features(train: dict, *others: dict):
    """Per-column feature standardization from TRAIN-set statistics.

    The reference BVP loader standard-scales its FEM export before
    training (``dataset_new.py`` keeps per-column statistics; its
    proprietary export arrives pre-scaled).  Our regenerated data keeps
    raw physics on disk (``sim/bvp_2d.py``: the source-density column
    reaches O(1e3)), so scaling is a loader concern: compute mean/std per
    feature column over VALID (non-pad) train nodes, apply to train and
    any held-out splits, and re-zero pad rows so padding stays inert.

    Returns ``(train', *others', stats)`` with ``stats = (mean, std)``.
    """
    m = train["pad_mask"][..., None].astype(np.float64)
    f = train["features"].astype(np.float64)
    denom = np.maximum(m.sum(axis=(0, 1)), 1.0)
    mean = (f * m).sum(axis=(0, 1)) / denom
    var = (((f - mean) ** 2) * m).sum(axis=(0, 1)) / denom
    std = np.maximum(np.sqrt(var), 1e-6)

    def apply(d):
        out = dict(d)
        g = (d["features"] - mean.astype(np.float32)) / std.astype(np.float32)
        out["features"] = (g * d["pad_mask"][..., None]).astype(np.float32)
        return out

    scaled = [apply(train)] + [apply(o) for o in others]
    return (*scaled, (mean.astype(np.float32), std.astype(np.float32)))


def masked_pointwise_loss(pred, target, mask, p: int = 1):
    """The reference's pointwise loss with pad masking: mean |pred - target|^p
    over valid nodes."""
    diff = torch.abs(pred - target) if p == 1 else (pred - target) ** p
    m = mask[..., None].to(pred.dtype)
    return torch.sum(diff * m) / torch.clamp(torch.sum(m) * pred.shape[-1], min=1.0)


@dataclasses.dataclass
class PointsetResult:
    params: object
    history: list


def _on(data: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in data.items()}


def pointset_step(model, opt, field_weight: float, loss_p: int):
    """The point-set training step: ``step(batch)`` (a dict of the data's
    arrays, this batch's rows) takes the masked pointwise loss of both
    heads, applies ``opt`` to the model's parameters and returns (loss,
    scalar loss, field loss)."""
    params = dict(model.named_parameters())

    def step(b):
        pm = b["pad_mask"]
        scalar, field = model(b["features"], b["coords"], pm, b["bound_mask"])
        ls = masked_pointwise_loss(scalar, b["scalar"], pm, p=loss_p)
        lf = masked_pointwise_loss(field, b["field"], pm, p=loss_p)
        loss = ls + field_weight * lf
        opt.step(params, grads_of(loss, params))
        return loss.detach(), ls.detach(), lf.detach()
    return step


def run_pointset_training(
    data: dict,
    *,
    latent_channels: int = 64,
    heads: int = 1,
    depth: int = 2,
    batch_size: int = 8,
    epochs: int = 10,
    learning_rate: float = 8e-4,
    field_weight: float = 0.5,
    loss_p: int = 1,
    clip: float | None = None,
    reference_recipe: bool = False,
    seed: int = 6,
    run_dir: str = "runs/pointset_bvp",
    log_every: int = 100,
    total_steps: int | None = None,
    init_params=None,
    device=None,
) -> PointsetResult:
    """Train the irregular-point-set operator.

    ``reference_recipe=True``: AMSGrad with weight decay 1e-4 added to the
    gradient, a warmup-cosine schedule (OneCycle's div 1e2, pct_start 0.1,
    final_div 1e4), clip 2.0 (or ``clip``), squared loss, field weight 1.0.
    ``total_steps``: an optimizer-step budget overriding ``epochs``."""
    dev = resolve_device(device)
    logger = MetricLogger(run_dir, name="pointset_bvp")
    rng = np.random.default_rng(seed)
    n = data["features"].shape[0]
    model = start_model(OFormerIrreg2D(data["features"].shape[-1], latent_channels, heads,
                                       depth, generator=torch.Generator().manual_seed(seed)),
                        init_params, dev)
    params = dict(model.named_parameters())
    arrs = _on(data, dev)

    steps_per_epoch = max(n // batch_size, 1)
    steps = total_steps if total_steps else max(epochs * steps_per_epoch, 1)
    epochs = -(-steps // steps_per_epoch)  # enough epochs to cover the budget
    if reference_recipe:
        loss_p, field_weight = 2, 1.0
        sched = warmup_cosine_decay_schedule(
            init_value=learning_rate / 1e2, peak_value=learning_rate,
            warmup_steps=max(int(0.1 * steps), 1), decay_steps=steps,
            end_value=learning_rate / 1e4)
        opt = AMSGrad(params, sched, 1e-4, clip=clip if clip is not None else 2.0)
    else:
        opt = AdamW(params, make_lr_schedule("cosine", learning_rate, steps), clip=clip)

    step = pointset_step(model, opt, field_weight, loss_p)
    history, gstep = [], 0
    for ep in range(epochs):
        order = rng.permutation(n)
        for b in range(0, n - batch_size + 1, batch_size):
            if gstep >= steps:
                break
            rows = torch.as_tensor(order[b:b + batch_size], device=dev)
            loss, ls, lf = step({k: v[rows] for k, v in arrs.items()})
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, loss=float(loss), scalar=float(ls), field=float(lf), epoch=ep)
        history.append({"epoch": ep, "loss": float(loss), "scalar_loss": float(ls),
                        "field_loss": float(lf)})
        if gstep >= steps:
            break
    return PointsetResult(params=trained_tree(model), history=history)


@torch.no_grad()
def evaluate_pointset(model, params, data: dict, device=None):
    """Masked metrics on held-out samples: the masked L1 of each head, the
    BVP suite's MSE of the potential, of the field (the mean of x and y)
    and their sum, and the masked relative L2.  ``params``: a flax tree to
    load into ``model`` first, or None for its own weights."""
    if params is not None:
        model.load_state_dict(oformer_flax_to_state_dict(params))
    dev = resolve_device(device)
    model = model.to(dev)
    d = _on(data, dev)
    scalar, field = model(d["features"], d["coords"], d["pad_mask"], d["bound_mask"])
    tgt_s, tgt_f, pm = d["scalar"], d["field"], d["pad_mask"]
    mse_pot = masked_pointwise_loss(scalar, tgt_s, pm, p=2)
    mse_field = masked_pointwise_loss(field, tgt_f, pm, p=2)
    m = pm[..., None].to(scalar.dtype)

    def rel_l2(pred, tgt):
        num = torch.sqrt(torch.sum((pred - tgt) ** 2 * m))
        return num / (torch.sqrt(torch.sum(tgt ** 2 * m)) + 1e-12)

    return {
        "scalar_l1": float(masked_pointwise_loss(scalar, tgt_s, pm)),
        "field_l1": float(masked_pointwise_loss(field, tgt_f, pm)),
        "mse_potential": float(mse_pot),
        "mse_field": float(mse_field),
        "mse_total": float(mse_pot + 2 * mse_field),
        "rel_l2_potential": float(rel_l2(scalar, tgt_s)),
        "rel_l2_field": float(rel_l2(field, tgt_f)),
    }


# --------------------------------------------------------------------------
# time-dependent point sets (airfoil class)
# --------------------------------------------------------------------------


def synthetic_vortex_sheet(
    seed: int,
    n_samples: int,
    n_points: int = 96,
    n_frames: int = 12,
    n_vortices: int = 3,
):
    """Time-dependent scattered-mesh flow: advecting Gaussian vortices
    sampled at fixed irregular nodes (the airfoil dataset's structure:
    fixed mesh, evolving (vx, vy, prs, dns) node states, integer node
    types distinguishing interior/boundary/obstacle)."""
    rng = np.random.default_rng(seed)
    fields = np.zeros((n_samples, n_frames, n_points, 4), np.float32)
    coords = np.zeros((n_samples, n_points, 2), np.float32)
    ntype = np.zeros((n_samples, n_points), np.int32)

    for s in range(n_samples):
        pts = rng.uniform(0, 1, size=(n_points, 2))
        on_edge = (pts.min(1) < 0.06) | (pts.max(1) > 0.94)
        centre = np.linalg.norm(pts - 0.5, axis=1) < 0.12
        ntype[s] = np.where(centre, 2, np.where(on_edge, 1, 0))
        coords[s] = pts

        amp = rng.uniform(0.5, 1.5, n_vortices)
        vx0 = rng.uniform(0.2, 0.8, (n_vortices, 2))
        drift = rng.uniform(-0.03, 0.03, (n_vortices, 2))
        for f in range(n_frames):
            cpos = vx0 + f * drift
            d = pts[:, None, :] - cpos[None, :, :]
            r2 = (d ** 2).sum(-1)
            g = np.exp(-r2 / 0.02)
            u = (-amp[None] * d[..., 1] * g).sum(1)
            v = (amp[None] * d[..., 0] * g).sum(1)
            prs = (amp[None] * g).sum(1)
            dns = 1.0 + 0.1 * prs
            fields[s, f] = np.stack([u, v, prs, dns], -1)
        fields[s, :, ntype[s] == 2] = 0.0  # no flow inside the obstacle

    return dict(fields=fields, coords=coords, node_type=ntype)


def _st_index(n: int, t: int, time_window: int, forward_steps: int) -> np.ndarray:
    w = t - time_window - forward_steps + 1
    return np.stack([np.repeat(np.arange(n), w), np.tile(np.arange(w), n)], 1).astype(np.int32)


def _st_batch(fields, coords, ntype, rows, time_window: int, forward_steps: int):
    """Rows (sample, t0) -> (inputs (B, tw, N, C + 2), node types, coordinates,
    targets (B, forward_steps, N, C))."""
    frames = rows[:, 1, None] + torch.arange(time_window + forward_steps, device=rows.device)
    win = fields[rows[:, 0, None], frames]
    x, y = win[:, :time_window], win[:, time_window:]
    p = coords[rows[:, 0]]
    pb = p[:, None].expand(*x.shape[:3], 2)
    return torch.cat([x, pb], dim=-1), ntype[rows[:, 0]], p, y


def _st_model(c: int, time_window: int, emb_dim: int, latent_channels: int, depth: int,
              generator=None):
    return OFormerIrregST2D(c + 2, c, time_window=time_window, emb_dim=emb_dim,
                            latent_channels=latent_channels, depth=depth, generator=generator)


def airfoil_step(model, opt, forward_steps: int):
    """The airfoil training step: ``step(inp, node_type, pos, y)`` takes the
    L1 of ``forward_steps`` predicted frames against ``y``, applies ``opt``
    to the model's parameters and returns the loss."""
    params = dict(model.named_parameters())

    def step(inp, nt, p, y):
        loss = torch.mean(torch.abs(model(inp, nt, p, forward_steps) - y))
        opt.step(params, grads_of(loss, params))
        return loss.detach()
    return step


def run_airfoil_training(
    data: dict,
    *,
    time_window: int = 4,
    forward_steps: int = 2,
    emb_dim: int = 48,
    latent_channels: int = 48,
    depth: int = 2,
    batch_size: int = 4,
    epochs: int = 10,
    learning_rate: float = 8e-4,
    seed: int = 6,
    run_dir: str = "runs/pointset_airfoil",
    log_every: int = 100,
    init_params=None,
    device=None,
):
    """Train the ST point-set operator: a window of ``time_window`` frames
    predicts the next ``forward_steps`` frames on the same scattered mesh
    (L1 loss)."""
    dev = resolve_device(device)
    logger = MetricLogger(run_dir, name="pointset_airfoil")
    rng = np.random.default_rng(seed)
    fields = torch.as_tensor(data["fields"], device=dev)
    coords = torch.as_tensor(data["coords"], device=dev)
    ntype = torch.as_tensor(data["node_type"], device=dev).long()
    n, t, _, c = fields.shape
    model = start_model(_st_model(c, time_window, emb_dim, latent_channels, depth,
                                  torch.Generator().manual_seed(seed)), init_params, dev)
    params = dict(model.named_parameters())
    idx = _st_index(n, t, time_window, forward_steps)
    batch_size = max(1, min(batch_size, len(idx)))
    opt = AdamW(params, make_lr_schedule("cosine", learning_rate,
                                         max(epochs * (len(idx) // batch_size), 1)))

    step = airfoil_step(model, opt, forward_steps)
    history, gstep = [], 0
    for ep in range(epochs):
        order = rng.permutation(len(idx))
        for b in range(0, len(idx) - batch_size + 1, batch_size):
            rows = torch.as_tensor(idx[order[b:b + batch_size]], dtype=torch.long, device=dev)
            loss = step(*_st_batch(fields, coords, ntype, rows, time_window, forward_steps))
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, l1=float(loss), epoch=ep)
        history.append({"epoch": ep, "l1": float(loss)})
    return PointsetResult(params=trained_tree(model), history=history)


@torch.no_grad()
def evaluate_airfoil(
    params, data: dict, *, time_window: int = 4, forward_steps: int = 2,
    emb_dim: int = 48, latent_channels: int = 48, depth: int = 2,
    batch_size: int = 8, device=None,
):
    """Held-out L1 and rel-L2 of the ST point-set operator over all windows."""
    dev = resolve_device(device)
    fields = torch.as_tensor(data["fields"], device=dev)
    coords = torch.as_tensor(data["coords"], device=dev)
    ntype = torch.as_tensor(data["node_type"], device=dev).long()
    n, t, _, c = fields.shape
    model = _st_model(c, time_window, emb_dim, latent_channels, depth)
    model.load_state_dict(oformer_flax_to_state_dict(params))
    model = model.to(dev)
    idx = _st_index(n, t, time_window, forward_steps)
    batch_size = max(1, min(batch_size, len(idx)))
    l1s, rels, nb = 0.0, 0.0, 0
    for b in range(0, len(idx) - batch_size + 1, batch_size):
        rows = torch.as_tensor(idx[b:b + batch_size], dtype=torch.long, device=dev)
        inp, nt, p, y = _st_batch(fields, coords, ntype, rows, time_window, forward_steps)
        pred = model(inp, nt, p, forward_steps)
        l1s += float(torch.mean(torch.abs(pred - y)))
        rels += float(torch.linalg.vector_norm(pred - y)
                      / (torch.linalg.vector_norm(y) + 1e-12))
        nb += 1
    return {"l1": l1s / max(nb, 1), "rel_l2": rels / max(nb, 1)}
