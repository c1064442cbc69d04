"""Checkpoints with the best-validation semantics of the reference, in the
JAX package's format: ``{run_dir}/{model_name}_ckpt`` is orbax's
``StandardCheckpointer`` directory (OCDBT, zarr v2, zstd) of ``{params,
opt_state, meta}``, written and read without orbax (``utils/orbax_tree.py``),
so a run moves between the packages in either direction.

``params`` is the flax-layout model tree, ``opt_state`` optax's state tree
of the optimizer that wrote it (each optimizer's ``optax_tree``;
``train/optim.py``, ``train/fast_step.py::opt_tree``) and ``meta``
``{epoch: int64, loss: float64}``, the types JAX's ``save_checkpoint``
gives them.  ``restore_checkpoint`` returns the tree with every array a
CPU tensor and optax's empty states as None; ``restore_params`` just the
parameters and the loss.  ``load_partial_params`` overlays a pretrained
tree (say, a masked-SSL checkpoint's) on a fresh one where path and shape
match.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from sciml_pde_torch.utils.orbax_tree import read_tree, write_tree


def save_checkpoint(path: str | Path, params: Any, opt_state: Any, epoch: int,
                    loss: float) -> None:
    """Write ``{params, opt_state, meta}`` at ``path`` (replacing it), as the
    JAX package's ``save_checkpoint`` does."""
    write_tree(path, {"params": params, "opt_state": opt_state,
                      "meta": {"epoch": np.asarray(int(epoch)),
                               "loss": np.asarray(float(loss))}})


def restore_checkpoint(path: str | Path) -> dict[str, Any]:
    """The whole tree of the checkpoint at ``path``, written by either
    package."""
    return read_tree(path)


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
