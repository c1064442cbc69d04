"""The port's host-streaming loaders and sharded samplers
(``sciml_pde_torch/data/stream.py``, ``data/windows.py``) against the JAX
package's: ``HostWindowLoader`` and ``AuxHostWindowLoader`` (NS row map and
DR pairing) over several seeds, shuffle on and off, prefetch on and off and
fewer rows than a batch; ``sharded_epoch_batches`` at 1, 2, 4 and 8 shards;
``sharded_gather_windows`` on each shard against JAX's ``shard_map`` gather.
Tolerance: none, every batch equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import stream as jstream
from sciml_pde_tpu.data import windows as jwin
from sciml_pde_tpu.parallel import make_mesh as jax_make_mesh
from sciml_pde_torch.data import stream, windows


def _store(n, t=9, xy=5, c=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, t, xy, xy, c)).astype(np.float32)


def _index(n, w):
    return np.stack([np.repeat(np.arange(n), w), np.tile(np.arange(w), n)], 1).astype(np.int32)


def _epochs(loader, n=2):
    return [[tuple(np.asarray(a) for a in b) for b in loader] for _ in range(n)]


def _same(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            for a, b in zip(bg, bw):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,shuffle,prefetch,n_rows,batch", [
    (0, True, True, 24, 5), (7, True, False, 24, 4), (3, False, True, 24, 6),
    (11, True, True, 3, 8), (5, False, False, 2, 4),
])
def test_host_loader_matches_jax(seed, shuffle, prefetch, n_rows, batch):
    """Two epochs of batches, shuffled by default_rng(seed), the remainder
    dropped and fewer rows than a batch tiled, as JAX's loader gives them."""
    data = _store(4)
    idx = _index(4, 5)[:n_rows]
    kw = dict(initial_step=3, rollout=2, batch_size=batch, shuffle=shuffle, seed=seed,
              prefetch=prefetch)
    got = stream.HostWindowLoader(data, idx, **kw)
    want = jstream.HostWindowLoader(data, idx, **kw)
    assert len(got) == len(want)
    _same(_epochs(got), _epochs(want))


@pytest.mark.parametrize("row_map", [False, True], ids=["dr_pairing", "ns_row_map"])
@pytest.mark.parametrize("seed,prefetch", [(0, True), (9, False)])
def test_aux_host_loader_matches_jax(row_map, seed, prefetch):
    """(x, y, xa, ya): the aux windows at the same t0 from rows p * nA + j
    (DR) or row_map[p] (NS), p-major, as JAX pairs them."""
    data, aux = _store(3), _store(9, seed=1)
    rm = np.random.default_rng(2).permutation(9).reshape(3, 3).astype(np.int32) \
        if row_map else None
    idx = _index(3, 5)
    kw = dict(initial_step=3, rollout=1, batch_size=4, num_aux=3, row_map=rm, seed=seed,
              prefetch=prefetch)
    _same(_epochs(stream.AuxHostWindowLoader(data, aux, idx, **kw)),
          _epochs(jstream.AuxHostWindowLoader(data, aux, idx, **kw)))


def test_bf16_host_store_gathers_like_the_device_gather():
    """A bf16 store stays a CPU tensor in host RAM; its host batches equal
    ``gather_windows`` on the same rows, bit for bit."""
    data = torch.as_tensor(_store(3)).to(torch.bfloat16)
    idx = _index(3, 5)
    x, y = next(iter(stream.HostWindowLoader(data, idx, 3, 1, batch_size=6, shuffle=False)))
    xd, yd = windows.gather_windows(data, torch.as_tensor(idx[:6], dtype=torch.long), 3, 1)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, xd) and torch.equal(y, yd)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_epoch_batches_match_jax(n_shards):
    """Shard-major batches with shard-local trajectory ids, the same draws
    as JAX's sampler from the same generator."""
    n_traj, batch = 8, 8
    idx = _index(n_traj, 6)
    got = list(windows.sharded_epoch_batches(idx, batch, n_traj, n_shards,
                                             np.random.default_rng(4)))
    want = list(jwin.sharded_epoch_batches(idx, batch, n_traj, n_shards,
                                           np.random.default_rng(4)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g[:, 0].max() < n_traj // n_shards
    with pytest.raises(ValueError, match="must divide n_shards"):
        next(windows.sharded_epoch_batches(idx, batch + 1, n_traj, 2))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_gather_matches_jax_shard_map(n_shards):
    """Each rank's windows from its store shard and its slice of a
    shard-major batch equal its slice of JAX's gather on a mesh of
    ``n_shards`` devices."""
    data = _store(8, t=10)
    idx = next(jwin.sharded_epoch_batches(_index(8, 6), 8, 8, n_shards,
                                          np.random.default_rng(1)))
    mesh = jax_make_mesh(data=n_shards, devices=jax.devices()[:n_shards])
    xj, yj = jwin.sharded_gather_windows(jnp.asarray(data), jnp.asarray(idx), 4, 1, mesh)
    per, b = 8 // n_shards, 8 // n_shards
    for r in range(n_shards):
        x, y = windows.sharded_gather_windows(torch.as_tensor(data[r * per:(r + 1) * per]),
                                              torch.as_tensor(idx[r * b:(r + 1) * b],
                                                              dtype=torch.long), 4, 1)
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj)[r * b:(r + 1) * b])
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj)[r * b:(r + 1) * b])
