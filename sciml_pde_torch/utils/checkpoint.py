"""Checkpoints with the best-validation semantics of the reference.

``torch.save`` of ``{params, opt_state, meta}``: ``params`` is the flax-layout
model tree (nested dicts of CPU tensors, the layout the JAX package's
checkpoints hold), ``opt_state`` the optimizer's state -- the Adam moments
and step count, as one flat vector each for the fused FNO step and per
named parameter for the production optimizers of ``train/optim.py`` --
and ``meta`` the epoch and the best validation loss.  Only the optimizer
state depends on the step that wrote it.

``restore_params`` returns the tree and the loss alone.
``load_partial_params`` overlays a pretrained tree (say, a masked-SSL
checkpoint's) on a fresh one where path and shape match.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return torch.as_tensor(tree)


def save_checkpoint(path: str | Path, params: Any, opt_state: dict, epoch: int,
                    loss: float) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {
        "params": _cpu(params),
        "opt_state": _cpu(opt_state),
        "meta": {"epoch": int(epoch), "loss": float(loss)},
    }
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str | Path) -> dict[str, Any]:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def restore_params(path: str | Path) -> tuple[Any, float]:
    """Just (params, best-val loss) of a checkpoint, for evaluation paths
    where the optimizer state is irrelevant: the flax-layout tree of CPU
    tensors and ``float(meta["loss"])``."""
    tree = restore_checkpoint(path)
    return tree["params"], float(tree["meta"]["loss"])


def _flatten(tree, prefix=()) -> dict[tuple, Any]:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flatten(sub, prefix + (key,)).items()}
    return {prefix: tree}


def partial_load_counts(params: dict, pretrained: dict) -> tuple[int, int]:
    """(leaves of ``params`` that ``load_partial_params`` takes from
    ``pretrained``, leaves it keeps fresh)."""
    flat_q = _flatten(pretrained)
    loaded = sum(1 for path, leaf in _flatten(params).items()
                 if path in flat_q and tuple(flat_q[path].shape) == tuple(leaf.shape))
    return loaded, len(_flatten(params)) - loaded


def load_partial_params(params: dict, pretrained: dict, verbose: bool = True) -> dict:
    """``params`` (a nested-dict tree) with each leaf replaced by the leaf of
    ``pretrained`` at the same path where that exists with the same shape;
    every other leaf kept (the reference's key-filtered partial loading of
    pretrained VideoMAE weights)."""
    flat_q = _flatten(pretrained)

    def overlay(node, prefix):
        if isinstance(node, dict):
            return {k: overlay(v, prefix + (k,)) for k, v in node.items()}
        cand = flat_q.get(prefix)
        return cand if cand is not None and tuple(cand.shape) == tuple(node.shape) else node

    if verbose:
        loaded, fresh = partial_load_counts(params, pretrained)
        print(f"load_partial_params: {loaded} loaded, {fresh} kept fresh")
    return overlay(params, ())
