"""Weight conversion between the flax FNO parameter trees (``FNO2d``,
``FNO2dAux``, ``FNO3d``, ``FNO3dAux``), the port's ``state_dict`` of the
same model and the fused step's packed parameters.  The baselines have one
head (``fc2``), the aux models two (``fc2_primary``, ``fc2_auxiliary``);
each is a flax ``TorchDense``.

Flax layouts: ``Dense`` kernels are ``(in, out)`` (torch ``nn.Linear``
weights are ``(out, in)``); spectral weights are ``(2, Cin, Cout, *modes)``
real/imag stacks (the same stack in both packages): in 2D ``w1`` for the
low corner rows and ``w2`` for the high ones, in 3D ``w1`` … ``w4`` for the
corners (+x, +y), (-x, +y), (+x, -y), (-x, -y).  The tree is nested dicts of
numpy arrays, as ``flax`` hands it out after ``jax.device_get``.

The VideoMAE transformers and the comparison models (OFormer, Hyena) keep
flax's names and layouts in the port, so their trees and ``state_dict`` map
by joining and splitting the keys at dots.
"""

from __future__ import annotations

import numpy as np
import torch

from sciml_pde_torch.ops.fno_fused_step import (
    L_LAYERS,
    FastFNOParams,
    pack_params,
    unpack_grads,
)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


_SPECTRAL = ("w1", "w2", "w3", "w4")


def flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """Flax FNO tree (2D or 3D, one head or two) -> the port's
    ``state_dict``: the backbone and every head the tree holds."""
    bb = tree["backbone"]
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))  # noqa: E731
    sd = {}

    def dense(prefix, d):
        sd[f"{prefix}.weight"] = t(_np(d["Dense_0"]["kernel"]).T)
        sd[f"{prefix}.bias"] = t(d["Dense_0"]["bias"])

    dense("backbone.fc0", bb["fc0"])
    dense("backbone.fc1", bb["fc1"])
    for i in range(L_LAYERS):
        for w in _SPECTRAL:
            if w in bb[f"conv{i}"]:
                sd[f"backbone.convs.{i}.{w}"] = t(bb[f"conv{i}"][w])
        dense(f"backbone.ws.{i}", bb[f"w{i}"])
    for head in sorted(k for k in tree if k != "backbone"):
        dense(head, tree[head])
    return sd


def state_dict_to_flax(sd) -> dict:
    """The port's FNO ``state_dict`` (2D or 3D, one head or two) -> flax tree
    of numpy arrays."""
    def dense(prefix):
        return {"Dense_0": {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(),
                            "bias": _np(sd[f"{prefix}.bias"])}}

    bb = {"fc0": dense("backbone.fc0"), "fc1": dense("backbone.fc1")}
    for i in range(L_LAYERS):
        bb[f"conv{i}"] = {w: _np(sd[f"backbone.convs.{i}.{w}"]) for w in _SPECTRAL
                          if f"backbone.convs.{i}.{w}" in sd}
        bb[f"w{i}"] = dense(f"backbone.ws.{i}")
    heads = sorted({n.split(".")[0] for n in sd if not n.startswith("backbone.")})
    return {"backbone": bb, **{h: dense(h) for h in heads}}


def flax_to_packed(tree, modes: int, device=None) -> FastFNOParams:
    """Flax FNO2d tree -> the fused step's packed parameters."""
    return pack_params(tree, modes, modes, device)


def packed_to_flax(p: FastFNOParams, modes: int) -> dict:
    """Packed parameters -> flax FNO2d tree of numpy arrays."""
    tree = unpack_grads(p, modes, modes)
    return tree_map(_np, tree)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)



# ---------------------------------------------------------------------------
# VideoMAEOperator: the port keeps flax's layout and names
# ---------------------------------------------------------------------------


def transformer_flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """Flax ``VideoMAEOperator`` tree -> the port's ``state_dict``: the keys
    joined with dots, the arrays as f32 tensors in the same layout (Dense
    kernels (in, out); ``qkv_kernel`` (dim, 3 * dim) with q | k | v along
    the output axis)."""
    sd = {}

    def walk(prefix, node):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(name, v)
            else:
                sd[name] = torch.as_tensor(np.array(v, dtype=np.float32))

    walk("", tree)
    return sd


def transformer_state_dict_to_flax(sd) -> dict:
    """The port's ``VideoMAEOperator`` ``state_dict`` -> flax tree of numpy
    arrays."""
    tree: dict = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _np(t).astype(np.float32, copy=True)
    return tree


# the comparison models (OFormer2D, OFormer1D, OFormerIrreg2D, OFormerIrregST2D,
# HyenaOFormer2D) keep flax's names and layouts too: the same converters
# (``decoder.prop_mlp_0_0.kernel``, ``hyena.h1.filter_fn.implicit_1.freq``)
oformer_flax_to_state_dict = transformer_flax_to_state_dict
oformer_state_dict_to_flax = transformer_state_dict_to_flax
