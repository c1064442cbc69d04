"""``run_training(host_stream=True)`` and ``run_transformer_training(
host_stream=True)`` of the port against the JAX package's, from the same
flax tree on the same files: the stores stay in host RAM, the loaders of
``data/stream.py`` gather each batch (the same batches as JAX's loader,
seeded the same) and the steps' ``xy`` variants train on them.

Cases: the NS FNO baseline, aux and aux at the aux store's native grid
(8^2 under a 12^2 primary), the DR FNO baseline and aux, and the NS
VideoMAE baseline and aux.  Tolerances: per-epoch train and validation
losses rtol 1e-4; trained parameters within 1e-4 of each leaf's largest
magnitude (FNO) or rtol 1e-3 / atol 1e-6 (transformer), f32 sums in
another order.  The port's streamed run also equals its device-store run
(losses rtol 1e-6)."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.models import FNO2dAux as FlaxFNO2dAux
from sciml_pde_tpu.models.transformer import VideoMAEOperator as FlaxVMAE
from sciml_pde_tpu.models.transformer import VideoMAEOperatorAux as FlaxVMAEAux
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_tpu.train.transformer_train import run_transformer_training as jax_run_tf
from sciml_pde_torch.train.fno_train import run_training
from sciml_pde_torch.train.transformer_train import run_transformer_training

from _torch_parity import assert_trees_close, precision, to_numpy_tree

SIM, AUX = "ns_incom_inhom_2d_256", "ns_aux_2d_256"
X, XA, NT, T0, C = 12, 8, 8, 3, 3


def _write_ns(path, n, x, nt, seed):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["velocity"] = rng.normal(size=(n, nt, x, x, 2)).astype(np.float32)
        f["particles"] = rng.uniform(size=(n, nt, x, x, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def ns_folder(tmp_path_factory):
    """NS files: primary 0-1 and test 250 (2 trajectories, 12^2, 8 frames);
    aux 0-3 at 12^2, and under ``low/`` at 8^2."""
    d = tmp_path_factory.mktemp("ns_stream")
    for i in (0, 1, 250):
        _write_ns(d / f"{SIM}-{i}.h5", 2, X, NT, i)
    (d / "low").mkdir()
    for i in range(4):
        _write_ns(d / f"{AUX}-{i}.h5", 2, X, NT, 50 + i)
        _write_ns(d / "low" / f"{AUX}-{i}.h5", 2, XA, NT, 70 + i)
    return d


@pytest.fixture(scope="module")
def dr_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("dr_stream")
    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, X, dtype=np.float32)
    t = np.linspace(0, 1, NT, dtype=np.float32)
    for s in range(10):
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(NT, X, X, 2)).astype(np.float32), lin, lin, t)
    for s in range(12):
        write_seed_group(d / "2D_diff-react_test_diff.h5", s,
                         rng.normal(size=(NT, X, X, 2)).astype(np.float32), lin, lin, t)
    return d


def _fno_init(aux, c):
    x0, g0 = jnp.zeros((1, X, X, T0, c)), jnp.zeros((1, X, X, 2))
    kw = dict(num_channels=c, modes1=3, modes2=3, width=6, initial_step=T0)
    key = jax.random.PRNGKey(3)
    if aux:
        return to_numpy_tree(jax.jit(FlaxFNO2dAux(**kw).init)(key, x0, g0, x0, g0)["params"])
    return to_numpy_tree(jax.jit(FlaxFNO2d(**kw).init)(key, x0, g0)["params"])


def _rel_trees(got, want, tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        err = np.abs(np.asarray(have) - leaf).max() / np.abs(leaf).max()
        assert err <= tol, f"{jax.tree_util.keystr(path)} off by {err:.3e} of its max"


def _same_history(got, want, rtol):
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=rtol)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=rtol)


FNO_CASES = {
    "ns_baseline": dict(dataset_family="ns", if_aux=False),
    "ns_aux": dict(dataset_family="ns", if_aux=True),
    "ns_aux_native_grid": dict(dataset_family="ns", if_aux=True, aux="low",
                               aux_upsample_at_gather=True, aux_native_compute=True),
    "dr_baseline": dict(dataset_family="dr", if_aux=False),
    "dr_aux": dict(dataset_family="dr", if_aux=True),
}


@pytest.mark.parametrize("name", FNO_CASES, ids=FNO_CASES.keys())
def test_fno_host_stream_matches_jax(ns_folder, dr_folder, tmp_path, name):
    case = dict(FNO_CASES[name])
    ns = case["dataset_family"] == "ns"
    base = ns_folder if ns else dr_folder
    aux_path = base / case.pop("aux", "")
    c = C if ns else 2
    kw = dict(case, base_path=str(base), aux_path=str(aux_path), test_range=(250, 251),
              train_subsample=(2, 2, 4), num_aux_samples=2, modes=3, width=6,
              initial_step=T0, num_channels=c, batch_size=4, epochs=2, learning_rate=2e-3,
              learning_rate_share=2e-3, learning_rate_fc2=1e-3, log_every=0, seed=3,
              host_stream=True, model_name="s")
    init = _fno_init(kw["if_aux"], c)
    with precision("highest"):
        want = jax_run_training(run_dir=str(tmp_path / "j"), **kw)
        got = run_training(run_dir=str(tmp_path / "t"), init_params=init, device="cpu", **kw)
        if name == "ns_aux":
            dev = run_training(run_dir=str(tmp_path / "d"), init_params=init, device="cpu",
                               **dict(kw, host_stream=False))
            _same_history(got, dev, 1e-6)
    assert len(got.history) == 2
    _same_history(got, want, 1e-4)
    _rel_trees(got.params, to_numpy_tree(want.params), 1e-4)


TINY = dict(img_size=16, patch_size=8, tubelet_size=2, in_chans=3, encoder_embed_dim=16,
            encoder_depth=1, encoder_num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=1, initial_step=4, batch_size=4, epochs=1, bf16=False,
            log_every=0, seed=5, grad_accum=2)


@pytest.fixture(scope="module")
def tf_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("tf_stream")
    for i in (0, 250):
        _write_ns(d / f"{SIM}-{i}.h5", 2, 16, 8, 10 + i)
    for i in range(2):
        _write_ns(d / f"{AUX}-{i}.h5", 2, 16, 8, 90 + i)
    return str(d)


@pytest.mark.parametrize("if_aux", [False, True], ids=["baseline", "aux"])
def test_transformer_host_stream_matches_jax(tf_folder, tmp_path, if_aux):
    """One epoch (12 windows: three micro-batches, one update under
    grad_accum 2 and the remainder kept), from JAX's init tree."""
    kw = dict(TINY, base_path=tf_folder, aux_path=tf_folder, dataset_family="ns",
              if_aux=if_aux, train_subsample=(1, 1, 2), num_aux_samples=2,
              test_range=(250, 251), host_stream=True, model_name="s")
    mk = dict(img_size=16, patch_size=8, tubelet_size=2, in_chans=3, num_frames=4,
              encoder_dim=16, encoder_depth=1, encoder_heads=2, decoder_dim=16,
              decoder_depth=1, decoder_heads=1)
    x0 = jnp.zeros((1, 4, 16, 16, 3))
    key = jax.random.PRNGKey(TINY["seed"])
    init = to_numpy_tree((jax.jit(FlaxVMAEAux(**mk).init)(key, x0, x0) if if_aux
                          else jax.jit(FlaxVMAE(**mk).init)(key, x0))["params"])
    want = jax_run_tf(run_dir=str(tmp_path / "j"), **kw)
    got = run_transformer_training(run_dir=str(tmp_path / "t"), init_params=init,
                                   device="cpu", **kw)
    _same_history(got, want, 1e-4)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=1e-3, atol=1e-6,
                       what="trained params")


def test_ns_drivers_stream_on_the_cpu(tmp_path):
    """The ported production drivers end to end at a tiny size with
    ``--host-stream`` (the bf16 aux store streams from a CPU tensor): the
    port's NS generator writes 32^2 files, the FNO and the VideoMAE train
    one epoch each, and ``summary.json`` holds JAX's keys with five finite
    rollout scores per variant."""
    from sciml_pde_torch.experiments import ns_production, ns_transformer

    data = str(tmp_path / "d")
    fno = ns_production.main(["--folder", data, "--out", str(tmp_path / "f"), "--grid", "32",
                              "--frames", "16", "--frame-int", "1", "--dt", "1e-3",
                              "--n-batch", "1", "--n-primary", "1", "--n-aux-per", "1",
                              "--n-test", "1", "--epochs", "1", "--host-stream",
                              "--device", "cpu"])
    tf = ns_transformer.main(["--data", data, "--out", str(tmp_path / "t"), "--img-size", "32",
                              "--patch-size", "8", "--encoder-dim", "16", "--encoder-depth",
                              "1", "--encoder-heads", "2", "--decoder-dim", "16",
                              "--decoder-depth", "1", "--decoder-heads", "1", "--epochs", "1",
                              "--batch-size", "2", "--grad-accum", "1",
                              "--num-aux-samples", "1", "--host-stream", "--precision",
                              "fp32", "--device", "cpu"])
    assert sorted(fno) == ["aux", "baseline"] and sorted(tf) == ["ns_aux", "ns_baseline"]
    for row in fno.values():
        assert sorted(row) == ["best_val", "resident_rotate", "resident_rotate_schedule",
                               "rollout_nrmse", "train_seconds"]
        assert len(row["rollout_nrmse"]) == 5 and np.isfinite(row["rollout_nrmse"]).all()
    for row in tf.values():
        assert sorted(row) == ["best_val", "conventions", "resident_rotate",
                               "resident_rotate_schedule", "rollout_nrmse",
                               "rollout_nrmse_allsteps", "train_seconds", "val_history"]
        assert len(row["rollout_nrmse"]) == 5 and np.isfinite(row["rollout_nrmse"]).all()
