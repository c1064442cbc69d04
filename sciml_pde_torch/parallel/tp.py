"""Channel-dim tensor parallelism over the mesh's 'model' axis (port of
``sciml_pde_tpu/parallel/tp.py``).

The JAX package places FNO parameters with NamedShardings from path rules
and lets GSPMD insert the collectives.  Here the rules are the same
(``fno_tp_rules``), ``shard_params_tp`` cuts each rank's block of every
leaf, and ``fno2d_tp_apply`` writes the collectives out: the column-parallel
FNO2d forward.  Each rank computes the Cout slice of every sharded layer
(lift, spectral conv, pointwise, the 128-wide projection, the head) from
the whole input, and an ``all_gather`` over the model row joins the
slices where the next layer needs every channel.

Gradients, as ``jax.grad`` through GSPMD gives them: the gather's
backward takes this rank's slice of the (replicated) output gradient, and
each sharded layer's input passes through an identity whose backward sums
the ranks' partial input gradients over the row.  So every shard's
gradient is its slice of the replicated model's gradient.  Layers whose
width the model axis does not divide stay replicated, with no collective.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sciml_pde_torch.models.common import gelu
from sciml_pde_torch.models.fno import _denorm, _prep
from sciml_pde_torch.ops.spectral import spectral_conv_2d
from sciml_pde_torch.parallel.mesh import AXES, Mesh, Sharding


class Sharded(NamedTuple):
    """This rank's block of a leaf, and the leaf's placement."""
    value: torch.Tensor
    sharding: Sharding


def _path_str(path) -> str:
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def fno_tp_rules(path, leaf, mesh: Mesh) -> Sharding:
    """Sharding rule for FNO params (``path``: the flax key path, a tuple
    of names or a '/'-joined string).

    - spectral weights (2, Cin, Cout, m1[, m2[, m3]]): shard Cout (axis 2);
    - Dense kernels (fan_in, fan_out): shard fan_out;
    - biases (fan_out,): shard when divisible;
    - everything else replicated.
    """
    n = mesh.shape[AXES.model]
    name = _path_str(path)
    shape = tuple(np.shape(leaf))
    if n > 1:
        if any(f"/w{i}" in name for i in range(1, 5)) and len(shape) >= 4:
            if shape[2] % n == 0:
                spec = [None] * len(shape)
                spec[2] = AXES.model
                return Sharding(mesh, tuple(spec))
        elif name.endswith("kernel") and len(shape) == 2 and shape[1] % n == 0:
            return Sharding(mesh, (None, AXES.model))
        elif name.endswith("bias") and len(shape) == 1 and shape[0] % n == 0:
            return Sharding(mesh, (AXES.model,))
    return Sharding(mesh, ())


def _block(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along the sharded axis."""
    if AXES.model not in sharding.spec:
        return x
    axis = sharding.spec.index(AXES.model)
    n, r = sharding.mesh.shape[AXES.model], sharding.mesh.model_rank
    size = x.shape[axis] // n
    return x.narrow(axis, r * size, size).contiguous()


def shard_params_tp(params: Any, mesh: Mesh, device=None) -> Any:
    """The flax-layout tree ``params`` with every leaf replaced by
    ``Sharded(this rank's block as an f32 tensor on device, its Sharding)``."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        sh = fno_tp_rules(prefix, node, mesh)
        t = torch.as_tensor(np.asarray(node.detach().cpu() if isinstance(node, torch.Tensor)
                                       else node, dtype=np.float32))
        return Sharded(_block(t, sh).to(device), sh)
    return walk(params, ())


class _ToModelRow(torch.autograd.Function):
    """Identity forward; the backward sums the row's partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherModelRow(torch.autograd.Function):
    """all_gather of the row's channel slices along the last axis; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.r, ctx.size = r, x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.r * ctx.size:(ctx.r + 1) * ctx.size].contiguous(), None, None, None


def _split(leaf: Sharded) -> bool:
    return AXES.model in leaf.sharding.spec


def _column(x, sharded: bool, layer, mesh: Mesh):
    """``layer(x)`` from the whole ``x``; where the layer is sharded, its
    input's gradient is summed over the row and its slices gathered."""
    if not sharded:
        return layer(x)
    n, r = mesh.shape[AXES.model], mesh.model_rank
    y = layer(_ToModelRow.apply(x, mesh.model_group))
    return _GatherModelRow.apply(y, mesh.model_group, n, r)


def _dense(d: dict):
    k, b = d["Dense_0"]["kernel"], d["Dense_0"]["bias"]
    return _split(k), lambda x: torch.matmul(x, k.value) + b.value


def fno2d_tp_apply(sharded: dict, x: torch.Tensor, grid: torch.Tensor, mesh: Mesh,
                   impl: str | None = None, padding: int = 2) -> torch.Tensor:
    """The FNO2d forward (``models/fno.py::FNO2d``) from ``shard_params_tp``'s
    tree: x (B, X, Y, T, C), grid (B, X, Y, 2) -> (B, X, Y, 1, C), the
    replicated model's output on every rank of the row."""
    bb = sharded["backbone"]
    nx, ny = x.shape[1], x.shape[2]
    inp, std, mean = _prep(x, grid)
    h = _column(inp, *_dense(bb["fc0"]), mesh)
    h = nn.functional.pad(h, (0, 0, 0, padding, 0, padding))
    for i in range(4):
        w1, w2 = bb[f"conv{i}"]["w1"], bb[f"conv{i}"]["w2"]
        _, pw = _dense(bb[f"w{i}"])
        m1, m2 = w1.value.shape[3], w1.value.shape[4]

        def layer(z, w1=w1.value, w2=w2.value, pw=pw, m1=m1, m2=m2, last=i == 3):
            y = spectral_conv_2d(z, w1, w2, m1, m2, impl) + pw(z)
            return y if last else gelu(y)
        h = _column(h, _split(w1), layer, mesh)
    h = h[:, :nx, :ny]
    split1, fc1 = _dense(bb["fc1"])
    h = _column(h, split1, lambda z: gelu(fc1(z)), mesh)
    out = _column(h, *_dense(sharded["fc2"]), mesh)
    return _denorm(out, std, mean)
