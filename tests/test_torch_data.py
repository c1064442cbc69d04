"""Port io/h5.py + data/dr.py + data/windows.py vs the JAX loaders on a
tiny DR file written with the JAX package's writer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data.dr import load_dr_baseline as jax_load
from sciml_pde_tpu.data.windows import epoch_batches as jax_batches
from sciml_pde_tpu.data.windows import gather_windows as jax_gather
from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_torch.data.dr import load_dr_baseline
from sciml_pde_torch.data.windows import epoch_batches, gather_windows

NT, X, Y, C = 9, 8, 6, 2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("dr")
    rng = np.random.default_rng(0)
    for s in range(11):
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(NT, Y, X, C)).astype(np.float32),
                         np.linspace(-1, 1, X, dtype=np.float32),
                         np.linspace(-1, 1, Y, dtype=np.float32),
                         np.linspace(0, 1, NT, dtype=np.float32))
    return str(d) + "/"


@pytest.mark.parametrize("subsample", [4, 0.5])
def test_load_dr_baseline_matches_jax(folder, subsample):
    want = jax_load(folder, train_subsample=subsample, initial_step=3, rollout_test=1)
    got = load_dr_baseline(folder, train_subsample=subsample, initial_step=3,
                           rollout_test=1, device="cpu")
    for g, w in ((got.train, want.train), (got.test, want.test)):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.window_index(), w.window_index())


def test_windows_and_batches_match_jax(folder):
    want = jax_load(folder, train_subsample=4, initial_step=3, rollout_test=1)
    got = load_dr_baseline(folder, train_subsample=4, initial_step=3, rollout_test=1,
                           device="cpu")
    idx = got.train.window_index()
    b_t = list(epoch_batches(idx, 5, np.random.default_rng(3)))
    b_j = list(jax_batches(want.train.window_index(), 5, np.random.default_rng(3)))
    assert len(b_t) == len(b_j) > 0
    for bt, bj in zip(b_t, b_j):
        np.testing.assert_array_equal(bt, bj)
        x, y = gather_windows(got.train.data, torch.from_numpy(bt).long(), 3, 1)
        xj, yj = jax_gather(want.train.data, jnp.asarray(bj), 3, 1)
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("initial_step, rollout", [(3, 6), (5, 1)])
def test_gather_past_the_end_matches_jax_clamp(initial_step, rollout):
    """Frame indices past a trajectory's end clamp to its last frame, as the
    JAX gather does: 12 frames, t0 = 8, 3 + 6 frames gives y = frames
    [11] * 6."""
    rng = np.random.default_rng(1)
    data = rng.normal(size=(2, 12, 4, 3, 2)).astype(np.float32)
    idx = np.array([[0, 8], [1, 11], [1, 2]], np.int32)
    x, y = gather_windows(torch.from_numpy(data), torch.from_numpy(idx).long(), initial_step,
                          rollout)
    xj, yj = jax_gather(jnp.asarray(data), jnp.asarray(idx), initial_step, rollout)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    if (initial_step, rollout) == (3, 6):
        np.testing.assert_array_equal(y.numpy()[0], np.repeat(data[0, 11][..., None, :], 6, -2))


def test_too_few_trajectories_raises(folder):
    with pytest.raises(ValueError, match="train trajectories"):
        load_dr_baseline(folder, train_subsample=50, initial_step=3, device="cpu")



@pytest.fixture(scope="module")
def small_folder(tmp_path_factory):
    """5 seeds: a 4-key train split and a 1-key test split."""
    d = tmp_path_factory.mktemp("dr_small")
    rng = np.random.default_rng(2)
    for s in range(5):
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(NT, Y, X, C)).astype(np.float32),
                         np.linspace(-1, 1, X, dtype=np.float32),
                         np.linspace(-1, 1, Y, dtype=np.float32),
                         np.linspace(0, 1, NT, dtype=np.float32))
    return str(d) + "/"


@pytest.mark.parametrize("subsample", [2.0, 4.0])
def test_float_count_subsample_matches_jax(small_folder, subsample):
    """A float train_subsample >= 1 is a count in both packages: it takes
    JAX's first keys of the train split."""
    want = jax_load(small_folder, train_subsample=subsample, initial_step=3, rollout_test=1)
    got = load_dr_baseline(small_folder, train_subsample=subsample, initial_step=3,
                           rollout_test=1, device="cpu")
    assert got.train.num_trajectories == int(subsample)
    np.testing.assert_array_equal(got.train.data.numpy(), np.asarray(want.train.data))


def test_float_count_beyond_the_split_raises_like_jax(small_folder):
    """8.0 train trajectories from a 4-key train split raise in both packages."""
    with pytest.raises(ValueError, match="train trajectories"):
        jax_load(small_folder, train_subsample=8.0, initial_step=3)
    with pytest.raises(ValueError, match="train trajectories"):
        load_dr_baseline(small_folder, train_subsample=8.0, initial_step=3, device="cpu")
