"""Fused FNO-2D training step (port of ``sciml_pde_tpu/train/fast_step.py``).

window gather -> fused model forward/backward (``ops/fno_fused_step.py``,
hand-written CUDA kernels on the card) -> nRMSE loss -> one flat-vector
optimizer: the ten packed parameter arrays live as views of a single f32
vector, so adaptive clip, L2 added to the gradient, Adam and the cosine
LR are a handful of elementwise ops on one vector.

Optimizer semantics are the production chain of the JAX package: clip to
max(5, 0.1 * ||g||) on the global norm, weight decay 1e-4 added to the
gradient before the Adam moments (torch ``Adam(weight_decay=...)``, not
AdamW), Adam(0.9, 0.999, 1e-8), cosine LR evaluated at the pre-increment
step count.  The optimizer is plain tensor code, as in the JAX package
where it is XLA and not a kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sciml_pde_torch.ops.fno_fused_step import (
    FastFNOParams,
    fno2d_fused_apply,
    pack_params,
    unpack_grads,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CLIP_FLOOR, CLIP_FRAC, WEIGHT_DECAY = 5.0, 0.1, 1e-4


class FlatSpec(NamedTuple):
    """Static flatten/unflatten recipe for FastFNOParams."""

    shapes: tuple
    sizes: tuple
    offsets: tuple

    @property
    def total(self) -> int:
        return int(self.offsets[-1] + self.sizes[-1])


def flat_spec(p: FastFNOParams) -> FlatSpec:
    shapes = tuple(tuple(a.shape) for a in p)
    sizes = tuple(int(np.prod(s)) for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
    return FlatSpec(shapes, sizes, offsets)


def flatten_params(p: FastFNOParams) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in p])


def unflatten_params(v: torch.Tensor, spec: FlatSpec) -> FastFNOParams:
    """Views of ``v`` (contiguous slices), so gradients flow back into it."""
    return FastFNOParams(*(
        v[off:off + size].view(shape)
        for off, size, shape in zip(spec.offsets, spec.sizes, spec.shapes)
    ))


class FlatOptState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: int


def init_opt(theta: torch.Tensor) -> FlatOptState:
    return FlatOptState(torch.zeros_like(theta), torch.zeros_like(theta), 0)


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _jax_shapes(spec: FlatSpec) -> list[tuple]:
    """The JAX package's FastFNOParams shapes for the port's ``spec``: its
    mode-mix blocks (wmr, wmi) are zero-padded to (L, C, O, ceil8(m2),
    ceil8(2 m1)) for its kernels' tiles; the other fields are the same."""
    out = [tuple(s) for s in spec.shapes]
    for i in (0, 1):
        *lead, k, r = out[i]
        out[i] = (*lead, _pad8(k), _pad8(r))
    return out


def to_jax_packing(flat: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """A flat vector in the port's packing (theta, or a moment of it) in the
    JAX package's: the mode-mix blocks padded with zeros (the pad slots of
    JAX's theta and moments hold exact zeros)."""
    parts = []
    for a, shape in zip(unflatten_params(flat.detach(), spec), _jax_shapes(spec)):
        if tuple(a.shape) != shape:
            a = torch.nn.functional.pad(a, (0, shape[-1] - a.shape[-1], 0,
                                            shape[-2] - a.shape[-2]))
        parts.append(a.reshape(-1))
    return torch.cat(parts)


def from_jax_packing(flat, spec: FlatSpec) -> torch.Tensor:
    """``to_jax_packing`` undone: the pad slots dropped."""
    flat = flat if isinstance(flat, torch.Tensor) else torch.from_numpy(np.array(flat))
    shapes = _jax_shapes(spec)
    sizes = [int(np.prod(s)) for s in shapes]
    if flat.numel() != sum(sizes):
        raise ValueError(f"a flat state of {flat.numel()} values is not the packing of these "
                         f"parameters ({sum(sizes)})")
    parts, off = [], 0
    for shape, size, want in zip(shapes, sizes, spec.shapes):
        a = flat[off:off + size].view(shape)
        parts.append(a[..., :want[-2], :want[-1]].reshape(-1) if len(shape) == 5
                     else a.reshape(-1))
        off += size
    return torch.cat(parts)


def opt_tree(opt: FlatOptState, spec: FlatSpec) -> dict:
    """The state as the JAX package's checkpoints hold its ``FlatOptState``:
    the flat moments in JAX's packing of theta, the count an int32."""
    return {"m": to_jax_packing(opt.m, spec).cpu(), "v": to_jax_packing(opt.v, spec).cpu(),
            "count": np.asarray(int(opt.count), np.int32)}


def opt_from_tree(tree, spec: FlatSpec, device=None) -> FlatOptState:
    """``opt_tree`` read back (a ValueError for another optimizer's state)."""
    if not (isinstance(tree, dict) and set(tree) == {"m", "v", "count"}):
        raise ValueError("the checkpoint's optimizer state is the production step's (a run "
                         "resumes with the fast_step setting it started with)")
    return FlatOptState(from_jax_packing(tree["m"], spec).to(device),
                        from_jax_packing(tree["v"], spec).to(device), int(tree["count"]))


def cosine_lr(base_lr: float, total_steps: int):
    def sched(count: int) -> float:
        frac = min(max(count / max(total_steps, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return sched


@torch.no_grad()
def optimizer_update(theta, opt: FlatOptState, gflat, sched):
    """clip -> +wd*theta -> adam -> -lr on the flat vector, in place on
    ``theta`` and the moments.  Returns (theta, opt', g_norm)."""
    g_norm = torch.sqrt(torch.sum(gflat * gflat))
    clip_value = torch.clamp(CLIP_FRAC * g_norm, min=CLIP_FLOOR)
    g = gflat * torch.clamp(clip_value / (g_norm + 1e-12), max=1.0)
    g = g + WEIGHT_DECAY * theta
    m = opt.m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
    v = opt.v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
    count = opt.count + 1
    mhat = m / (1.0 - ADAM_B1 ** count)
    vhat = v / (1.0 - ADAM_B2 ** count)
    update = mhat / (torch.sqrt(vhat) + ADAM_EPS)
    # the schedule is read at the pre-increment count, as optax's
    # scale_by_learning_rate at the end of the production chain
    theta.sub_(update, alpha=sched(opt.count))
    return theta, FlatOptState(m, v, count), g_norm


def nrmse_loss_cf(pred, tar):
    """nrmse_loss for channels-first (B, C, X, Y)."""
    residuals = pred - tar
    tar_norm = 1e-7 + (tar * tar).mean(dim=(2, 3), keepdim=True)
    raw = (residuals * residuals).mean(dim=(2, 3), keepdim=True) / tar_norm
    return raw.mean()


def fast_gather(data, idx, initial_step: int):
    """data (N, T, X, Y, C), idx (B, 2) -> win (B, T0, C, X, Y), y (B, C, X, Y).

    Frame indices past the end of a trajectory are clamped to its last
    frame, as the JAX gather clamps them (and as ``gather_windows`` does)."""
    span = initial_step + 1
    offs = torch.arange(span, device=idx.device, dtype=idx.dtype)
    frames = torch.clamp(idx[:, 1, None] + offs[None, :], 0, data.shape[1] - 1)
    win5 = data[idx[:, 0, None], frames].float()
    x = win5[:, :initial_step].permute(0, 1, 4, 2, 3).contiguous()
    y = win5[:, initial_step].permute(0, 3, 1, 2).contiguous()
    return x, y


def build_fast_baseline_step(
    modes: int,
    initial_step: int,
    spec: FlatSpec,
    learning_rate: float = 1e-3,
    total_steps: int = 10_000,
    pad: int = 2,
):
    """Returns (step, step_scan) over (theta_flat, FlatOptState).

    step(theta, opt, data, grid2, idx) -> (theta, opt, loss, g_norm) is the
    single-rollout training step; ``theta`` is updated in place.
    step_scan(theta, opt, data, grid2, idx_chunk) -> (theta, opt, losses,
    g_norms) runs one step per (B, 2) row block of a (K, B, 2) chunk and
    returns the K losses and grad norms as tensors on the device, with no
    host sync in the loop (the JAX package's ``lax.scan``)."""
    sched = cosine_lr(learning_rate, total_steps)

    def step(theta, opt, data, grid2, idx):
        with torch.enable_grad():
            leaf = theta.detach().requires_grad_(True)
            p = unflatten_params(leaf, spec)
            x, y = fast_gather(data, idx, initial_step)
            loss = nrmse_loss_cf(fno2d_fused_apply(x, grid2, p, modes, modes, pad), y)
            (g,) = torch.autograd.grad(loss, leaf)
        theta, opt, g_norm = optimizer_update(theta, opt, g, sched)
        return theta, opt, loss.detach(), g_norm

    def step_scan(theta, opt, data, grid2, idx_chunk):
        losses, g_norms = [], []
        for idx in idx_chunk:
            theta, opt, loss, g_norm = step(theta, opt, data, grid2, idx)
            losses.append(loss)
            g_norms.append(g_norm)
        return theta, opt, torch.stack(losses), torch.stack(g_norms)

    return step, step_scan


def fast_state_from_tree(tree, modes: int, device=None):
    """Flax param tree -> (theta_flat, FlatSpec)."""
    p = pack_params(tree, modes, modes, device)
    return flatten_params(p), flat_spec(p)


def tree_from_fast_state(theta, spec: FlatSpec, modes: int, like_tree=None):
    """theta_flat -> flax param tree of tensors (checkpoint interchange)."""
    return unpack_grads(unflatten_params(theta.detach(), spec), modes, modes, like_tree)
