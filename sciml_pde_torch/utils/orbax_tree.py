"""The directory of orbax's ``StandardCheckpointer``: a pytree of arrays
written and read without orbax, tensorstore or JAX.

    {path}/_CHECKPOINT_METADATA   JSON: the handler, timestamps
    {path}/_METADATA              JSON: ``tree_metadata``, one entry per
                                  leaf, keyed by the str of its key tuple:
                                  ``key_metadata`` [{key, key_type}] (2 a
                                  dict key or a named field, 1 a sequence
                                  index) and ``value_metadata`` {value_type,
                                  skip_deserialize}; ``use_ocdbt``,
                                  ``use_zarr3`` ...
    {path}/manifest.ocdbt, d/     one OCDBT database (``io/ocdbt.py``) of
                                  zarr v2 arrays (``io/zarr2.py``), each
                                  named by its keys joined with dots

A tree here is nested dicts (key_type 2) and lists (key_type 1) with
array leaves (numpy arrays, torch tensors, numbers) and empty leaves:
None (``value_type`` "None", as optax's ``EmptyState`` and ``MaskedNode``
are saved), ``()`` ("Tuple", ``MultiStepsState.skip_state``) and ``{}``
("Dict").  None is stored and each comes back as it went.  ``write_tree`` writes into a temporary directory beside
``path`` and renames it into place, as orbax does; ``read_tree`` rebuilds
the tree from ``_METADATA`` alone (orbax's restore without a template),
every array a CPU tensor.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from sciml_pde_torch.io import zarr2
from sciml_pde_torch.io.ocdbt import OcdbtReader, write_database

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_EMPTY = {"None": None, "Tuple": (), "Dict": {}}
DICT_KEY, SEQUENCE_KEY = 2, 1


def _empty_type(leaf) -> str | None:
    if leaf is None:
        return "None"
    for name, empty in (("Tuple", ()), ("Dict", {})):
        if type(leaf) is type(empty) and len(leaf) == 0:
            return name
    return None


def _leaves(tree, path=()):
    """(key path as [(key, key_type)], leaf) of every leaf, empty ones too."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, path + ((str(k), DICT_KEY),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + ((str(i), SEQUENCE_KEY),))
    else:
        yield path, tree


def _as_array(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, zarr2.dtype_name(a)


def write_tree(path: str | Path, tree: dict) -> None:
    """Write ``tree`` as orbax's ``StandardCheckpointer`` directory at
    ``path``, replacing what is there."""
    path = Path(path).absolute()
    t0 = time.time_ns()
    tmp = path.with_name(f"{path.name}.orbax-checkpoint-tmp-{t0}")
    items: dict[str, bytes] = {}
    meta = {}
    for keys, leaf in _leaves(tree):
        names = [k for k, _ in keys]
        empty = _empty_type(leaf)
        if empty is None:
            a, dtype = _as_array(leaf)
            items.update(zarr2.array_items(".".join(names), a, dtype))
        meta[str(tuple(names))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in keys],
            "value_metadata": {"value_type": empty or "np.ndarray",
                               "skip_deserialize": empty is not None}}
    tmp.mkdir(parents=True)
    try:
        write_database(tmp, items)
        (tmp / "_METADATA").write_text(json.dumps(
            {"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
             "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps(
            {"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
             "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
             "custom_metadata": {}}))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())  # keeps 0-d arrays 0-d
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def read_tree(path: str | Path) -> dict:
    """The tree of the orbax checkpoint at ``path`` (written by orbax or by
    ``write_tree``): nested dicts and lists as ``_METADATA`` records them,
    arrays as CPU tensors, empty leaves as saved."""
    path = Path(path)
    if not (path / "_METADATA").is_file():
        raise FileNotFoundError(f"{path} is not an orbax checkpoint (no _METADATA)")
    meta = json.loads((path / "_METADATA").read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays are read")
    store = OcdbtReader(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        if vm["value_type"] in _EMPTY:
            leaf = _EMPTY[vm["value_type"]]
            leaf = type(leaf)() if leaf is not None else None
        else:
            leaf = _tensor(*zarr2.read_array(".".join(k for k, _ in keys), store.get))
        node = root
        for depth, (k, kt) in enumerate(keys):
            key = (kt, k)
            if depth == len(keys) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
    return _rebuild(root)


def _rebuild(node):
    if not isinstance(node, dict) or not node or not all(isinstance(k, tuple) for k in node):
        return node
    if all(kt == SEQUENCE_KEY for kt, _ in node):
        return [_rebuild(node[k]) for k in sorted(node, key=lambda k: int(k[1]))]
    return {k: _rebuild(v) for (_, k), v in node.items()}


def flatten(tree: Any) -> dict[tuple, Any]:
    """{key path: leaf} of a tree of dicts and lists (empty leaves kept)."""
    return {tuple(k for k, _ in keys): leaf for keys, leaf in _leaves(tree)}
