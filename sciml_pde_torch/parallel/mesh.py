"""The ('data', 'model') mesh over the ranks of a process group, and the
sharding helpers of the trainers (port of
``sciml_pde_tpu/parallel/mesh.py``).

The JAX package shards one program's arrays over its devices; here each
rank holds its own part.  The mesh is a plain record of the ranks:
without a process group it is one rank, 1 x 1, as JAX's is on one chip.

  ``shard_batch``     this rank's contiguous rows of a batch (the whole
                      batch where the data axis does not divide it)
  ``replicate``       rank 0's tensors broadcast to every rank, in place
  ``mean_over_ranks`` a tensor's mean over the ranks, in place (gradients
                      and losses of data parallelism)

A mesh of ``model > 1`` lays the ranks out data-major, as JAX's
``reshape(data, model)``: rank index ``i`` of ``ranks`` sits at data
position ``i // model`` and model position ``i % model``.  In a process
group the mesh holds the group of its model row (``model_group``, the
collectives of tensor parallelism, ``parallel/tp.py``) and of its data
column (``data_group``, the gradient mean of data parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a (data, model) mesh, data-major.  ``model_group`` and
    ``data_group`` are the process groups of this rank's model row and data
    column where ``model > 1`` in a process group, else None (the whole
    group)."""
    ranks: tuple[int, ...]
    data: int
    model: int = 1
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {AXES.data: self.data, AXES.model: self.model}

    def _index(self) -> int:
        return self.ranks.index(dist.get_rank()) if dist.is_initialized() else 0

    @property
    def rank(self) -> int:
        """This process's position along the data axis (0 without a group)."""
        return self._index() // self.model

    @property
    def model_rank(self) -> int:
        """This process's position along the model axis (0 without a group)."""
        return self._index() % self.model


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array's axes go: ``spec[0] == 'data'`` splits the leading
    axis over the data axis; an empty spec replicates."""
    mesh: Mesh
    spec: tuple


def make_mesh(data: int = -1, model: int = 1, devices: Sequence[int] | None = None) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (ranks; default: every rank
    of the process group, or the one process without a group).  ``data=-1``
    takes all ranks ``model`` leaves.  With ``model > 1`` in a process group
    every rank must make the same mesh: the row and column groups are made
    collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = tuple(devices if devices is not None else range(world))
    n = len(ranks)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    model_group = data_group = None
    if model > 1 and dist.is_initialized():
        me = dist.get_rank()
        for d in range(data):  # new_group is collective: every rank makes every group
            row = dist.new_group(list(ranks[d * model:(d + 1) * model]))
            model_group = row if me in ranks[d * model:(d + 1) * model] else model_group
        for m in range(model):
            col = dist.new_group(list(ranks[m::model]))
            data_group = col if me in ranks[m::model] else data_group
    return Mesh(ranks=ranks, data=data, model=model, model_group=model_group,
                data_group=data_group)


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, (AXES.data, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def trajectory_sharding(mesh: Mesh) -> Sharding:
    """A trajectory store split over the data axis: each rank holds
    ``N / n_data`` whole trajectories (the ``shard_store`` layout)."""
    return Sharding(mesh, (AXES.data,))


def _rows(x, mesh: Mesh):
    n = mesh.shape[AXES.data]
    if n == 1 or x.shape[0] % n != 0:
        return x
    b = x.shape[0] // n
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf (numpy or tensor) of ``batch``: the
    contiguous ``B / n`` rows of rank r along the data axis, or the whole
    leaf where ``n`` does not divide its leading axis (as JAX replicates
    such a batch)."""
    return _tree_map(lambda x: _rows(x, mesh), batch)


def _grouped() -> bool:
    """Whether collectives run: in a process group, even one of one rank
    (where they are exact no-ops), so that the path runs wherever a group
    was set up."""
    return dist.is_initialized()


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` (parameters, optimizer state) overwritten in
    place by rank 0's; other leaves stay as they are.  Returns ``tree``."""
    if _grouped():
        def bcast(x):
            if isinstance(x, torch.Tensor):
                dist.broadcast(x.data, src=mesh.ranks[0])
            return x
        _tree_map(bcast, tree)
    return tree


def mean_over_ranks(tensors, mesh: Mesh):
    """The mean over the data axis of each tensor of ``tensors`` (one tensor
    or a list), in place, in one all-reduce of their flattened values (none
    without a process group).  Returns its argument."""
    if not _grouped():
        return tensors
    ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.shape[AXES.data]
    off = 0
    for t in ts:
        t.detach().copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[AXES.data]
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n


class _RankMeanGrads:
    """``opt`` whose ``step(params, grads)`` first replaces the gradients by
    their mean over the data axis; everything else is ``opt``'s."""

    def __init__(self, opt, mesh: Mesh):
        self._opt, self._mesh = opt, mesh

    def step(self, params, grads):
        mean_over_ranks(list(grads.values()), self._mesh)
        return self._opt.step(params, grads)

    def __getattr__(self, name):
        return getattr(self._opt, name)


def data_parallel(opt, mesh: Mesh):
    """An optimizer for data parallelism over ``mesh``: every rank's step
    sees the mean of the ranks' gradients (before its clip), which is the
    global batch's gradient where each rank's loss is a mean over an equal
    share of the batch.  ``opt`` itself without a process group."""
    return _RankMeanGrads(opt, mesh) if _grouped() else opt
