"""Port eval/rollout.py, eval/analyse.py and the evaluation branch of
run_training vs the JAX package's, from one flax FNO2d tree on the same
numpy-seeded stores and HDF5 files.

The model's forward is a DFT, so every rollout number is held to 1e-4
relative (the metrics' own f32 parity, 1e-5, is in test_torch_metrics.py).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data.windows import WindowedTrajectories as JaxWindows
from sciml_pde_tpu.eval import analyse as jax_analyse
from sciml_pde_tpu.eval import rollout as jr
from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.eval import analyse
from sciml_pde_torch.eval import rollout as tr
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.train.fno_train import run_training
from sciml_pde_torch.utils.checkpoint import save_checkpoint
from sciml_pde_torch.utils.weights import flax_to_state_dict

from _torch_parity import precision, to_numpy_tree

N, NT, X, C, T0, MODES, WIDTH = 5, 12, 16, 2, 4, 4, 8
RTOL = 1e-4
NAMES = ("RMSE", "nRMSE", "CSV", "Max", "BD", "F")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N, NT, X, X, C)).astype(np.float32)
    lin = np.linspace(0, 1, X, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = np.stack([gx, gy], -1)
    flax_model = FlaxFNO2d(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH,
                           initial_step=T0)
    params = to_numpy_tree(flax_model.init(jax.random.PRNGKey(1), jnp.zeros((1, X, X, T0, C)),
                                           jnp.zeros((1, X, X, 2)))["params"])
    model = FNO2d(C, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(params))

    def jax_apply(p, x, g):
        return flax_model.apply({"params": p}, x, g)

    return data, grid, params, jax_apply, model


def _windows(data, grid, rollout):
    return (JaxWindows(jnp.asarray(data), jnp.asarray(grid), initial_step=T0, rollout=rollout,
                       train=False),
            WindowedTrajectories(data, grid, initial_step=T0, rollout=rollout, train=False))


def test_rollout_predict_matches_jax(setup):
    data, grid, params, jax_apply, model = setup
    x = np.moveaxis(data[:2, :T0], 1, -2)
    g = np.broadcast_to(grid[None], (2, X, X, 2)).copy()
    with precision("highest"), torch.no_grad():
        want = jr.rollout_predict(lambda a, b: jax_apply(params, a, b), jnp.asarray(x),
                                  jnp.asarray(g), 3)
        got = tr.rollout_predict(model, torch.from_numpy(x), torch.from_numpy(g), 3)
    assert got.shape == (2, X, X, 3, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("score", ["final", "all_steps"])
def test_evaluate_rollout_matches_jax_with_a_ragged_batch(setup, score):
    """Five test windows in batches of 2: the ragged last batch weighs as
    much as a full one in both packages."""
    data, grid, params, jax_apply, model = setup
    jw, tw = _windows(data, grid, 3)
    with precision("highest"):
        want = jr.evaluate_rollout(jax_apply, jw, 3, batch_size=2, iLow=2, iHigh=6,
                                   params=params, score=score)
        got = tr.evaluate_rollout(model, tw, 3, batch_size=2, iLow=2, iHigh=6, score=score)
    assert sorted(got) == sorted(want)
    for k in NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert len(got["mse_time"]) == 3
    np.testing.assert_allclose(got["mse_time"], want["mse_time"], rtol=RTOL)
    # the ragged batch counts once: the mean of the three batches' values
    per_batch = [tr.evaluate_rollout(model, WindowedTrajectories(
        data[b:b + 2], grid, initial_step=T0, rollout=3, train=False), 3, batch_size=2,
        iLow=2, iHigh=6, score=score)["nRMSE"] for b in (0, 2, 4)]
    np.testing.assert_allclose(got["nRMSE"], np.mean(per_batch), rtol=1e-6)


def test_evaluate_rollout_default_bands_give_nan_like_jax(setup):
    """At 16^2 the default iHigh 12 leaves the high band empty: F is NaN in
    both packages and the other five are finite."""
    data, grid, params, jax_apply, model = setup
    jw, tw = _windows(data, grid, 1)
    with precision("highest"):
        want = jr.evaluate_rollout(jax_apply, jw, 1, batch_size=4, params=params)
        got = tr.evaluate_rollout(model, tw, 1, batch_size=4)
    assert np.isnan(got["F"]) and np.isnan(want["F"])
    for k in NAMES[:5]:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_convention_table_matches_jax(setup):
    data, grid, params, jax_apply, model = setup
    jw, tw = _windows(data, grid, 3)
    with precision("highest"):
        want = jr.convention_table(jax_apply, jw, 3, params=params, batch_size=2)
        got = tr.convention_table(model, tw, 3, batch_size=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == 3
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


# ---- run_training(if_training=False) on HDF5 files ---------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny DR file and one JAX epoch on it: the tree both packages'
    checkpoints then hold (the epoch's best is its last)."""
    d = tmp_path_factory.mktemp("dr_eval")
    rng = np.random.default_rng(4)
    lin = np.linspace(0, 1, X, dtype=np.float32)
    for s in range(10):  # 9 train, 1 test
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(NT, X, X, C)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, NT, dtype=np.float32))
    kw = dict(base_path=str(d) + "/", train_subsample=(4, 2, 6), modes=MODES, width=WIDTH,
              initial_step=T0, num_channels=C, batch_size=4, epochs=1, log_every=0, seed=3,
              run_dir=str(d / "j"), model_name="DR_ds4_FNO")
    with precision("highest"):
        res = jax_run_training(fast_step=False, **kw)
    tree = to_numpy_tree(res.params)
    save_checkpoint(d / "t" / "DR_ds4_FNO_ckpt", tree, {}, 0, res.best_val)
    return d, kw, tree


@pytest.mark.parametrize("rollout", [1, 4])
def test_eval_branch_writes_what_jax_writes(trained, rollout):
    """The six-metric pickle (a tuple of numpy float64, JAX's types) and
    mse_time.npz from the same tree on the same test split."""
    d, kw, tree = trained
    ev = dict(kw, if_training=False, rollout_test=rollout, iLow=2, iHigh=6)
    with precision("highest"):
        want = jax_run_training(**ev)
        got = run_training(**dict(ev, run_dir=str(d / "t")), device="cpu")
    np.testing.assert_allclose(got.best_val, want.best_val, rtol=RTOL)
    with (d / "j" / "DR_ds4_FNO.pickle").open("rb") as f:
        pj = pickle.load(f)
    with (d / "t" / "DR_ds4_FNO.pickle").open("rb") as f:
        pt = pickle.load(f)
    assert type(pt) is type(pj) is tuple and len(pt) == 6
    assert [type(v) for v in pt] == [type(v) for v in pj] == [np.float64] * 6
    np.testing.assert_allclose(pt, pj, rtol=RTOL)
    nj, nt = (np.load(d / w / "DR_ds4_FNO_mse_time.npz") for w in ("j", "t"))
    assert sorted(nt.files) == sorted(nj.files) == ["mse", "t"]
    np.testing.assert_array_equal(nt["t"], np.arange(T0, T0 + rollout))
    assert nt["t"].dtype == nj["t"].dtype and nt["mse"].dtype == nj["mse"].dtype
    np.testing.assert_array_equal(nt["t"], nj["t"])
    np.testing.assert_allclose(nt["mse"], nj["mse"], rtol=RTOL)

    # either package's collect reads either package's pickle
    frames = [c(d / w) for c in (analyse.collect, jax_analyse.collect) for w in ("j", "t")]
    for df in frames:
        assert list(df.index) == [("DR", "ds4", "FNO")]
        assert list(df.columns) == [*NAMES, "file"]
        np.testing.assert_allclose(df[list(NAMES)].to_numpy()[0], frames[0][list(NAMES)]
                                   .to_numpy()[0], rtol=RTOL)
    assert analyse.parse_name("DR_ds4_FNO") == jax_analyse.parse_name("DR_ds4_FNO")


def test_eval_branch_needs_the_checkpoint_and_refuses_plot(trained, tmp_path):
    """Without the checkpoint the evaluation raises, with or without
    ``plot`` (no longer refused: the figure comes after the metrics, as in
    JAX) and writes no figure."""
    d, kw, _ = trained
    ev = dict(kw, if_training=False, run_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        run_training(**ev, device="cpu")
    with pytest.raises(FileNotFoundError):
        run_training(**dict(ev, plot=True), device="cpu")
    assert not list(tmp_path.glob("*.png"))


def test_analyse_main_writes_results_csv(trained, tmp_path):
    d, _, _ = trained
    out = tmp_path / "Results.csv"
    analyse.main(["--results-dir", str(d / "j"), "--out", str(out)])
    text = out.read_text().splitlines()
    assert text[0].startswith("pde,param,model,RMSE,nRMSE,CSV,Max,BD,F")
    assert len(text) == 2
