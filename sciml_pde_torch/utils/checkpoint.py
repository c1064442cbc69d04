"""Checkpoints with the best-validation semantics of the reference.

``torch.save`` of ``{params, opt_state, meta}``: ``params`` is the flax-layout
model tree (nested dicts of CPU tensors, the layout the JAX package's
checkpoints hold), ``opt_state`` the optimizer's state -- the Adam moments
and step count, as one flat vector each for the fused FNO step and per
named parameter for the production optimizers of ``train/optim.py`` --
and ``meta`` the epoch and the best validation loss.  Only the optimizer
state depends on the step that wrote it.
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
