"""Pool rotation (``resident_rotate=R``) in both trainers of the port
against the JAX package's: the pool stays in host RAM and one 1/R
trajectory slice is on the device, swapped between epochs under the
``block``, ``interleave`` and ``cyclic`` schedules.

Held to JAX, from the same flax tree on the same files: the FNO's aux
joint training (the aux pool re-laid in pairing order) and the VideoMAE
baseline under each schedule, full history; a ``continue_training``
resume that starts in the second slice.  JAX's oracle in the port: a pool
of two byte-identical slices trains exactly like the unrotated run on one
slice.  Tolerances: per-epoch losses rtol 1e-4 against JAX (the oracle
rtol 1e-6), trained FNO parameters within 5e-4 of each leaf's largest
magnitude, transformer parameters rtol 1e-3 / atol 1e-6."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sciml_pde_tpu.models import FNO2dAux as FlaxFNO2dAux
from sciml_pde_tpu.models.transformer import VideoMAEOperator as FlaxVMAE
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_tpu.train.transformer_train import run_transformer_training as jax_run_tf
from sciml_pde_torch.train.fno_train import run_training
from sciml_pde_torch.train.transformer_train import run_transformer_training

from _torch_parity import assert_trees_close, precision, to_numpy_tree

SIM, AUX = "ns_incom_inhom_2d_256", "ns_aux_2d_256"
X, NT, T0 = 12, 8, 3


def _smooth(n, x, nt, seed):
    """Learnable trajectories: smooth fields decaying in time."""
    rng = np.random.default_rng(seed)
    k = np.linspace(0, 2 * np.pi, x, dtype=np.float32)
    freq = rng.uniform(1, 2, (n, 1, 1, 1, 3))
    base = (np.sin(freq * k[:, None, None] + k[None, :, None])
            + 0.1 * rng.normal(size=(n, 1, x, x, 3))).astype(np.float32)
    decay = np.exp(-0.1 * np.arange(nt, dtype=np.float32))[None, :, None, None, None]
    return (base * decay).astype(np.float32)


def _write(path, arr):
    with h5py.File(path, "w") as f:
        f["velocity"] = arr[..., :2]
        f["particles"] = arr[..., 2:]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """``mixed/``: primary files 0, 1 and aux files 0, 1 all different;
    ``same/``: file 1 a copy of file 0 (two byte-identical slices); test
    file 250 in both."""
    out = {}
    for name in ("mixed", "same"):
        d = tmp_path_factory.mktemp(name)
        for i in (0, 1):
            src = 0 if name == "same" else i
            _write(d / f"{SIM}-{i}.h5", _smooth(2, X, NT, src))
            _write(d / f"{AUX}-{i}.h5", _smooth(2, X, NT, 10 + src))
        _write(d / f"{SIM}-250.h5", _smooth(1, X, NT, 99))
        out[name] = str(d)
    return out


def _fno_kw(folder, **kw):
    return dict(dict(base_path=folder, aux_path=folder, dataset_family="ns", if_aux=True,
                     train_subsample=(2, 2, 2), num_aux_samples=1, test_range=(250, 251),
                     num_channels=3, modes=3, width=6, initial_step=T0, batch_size=2,
                     epochs=2, learning_rate_share=3e-3, learning_rate_fc2=3e-3, seed=7,
                     log_every=0, model_name="r"), **kw)


def _fno_init():
    x0, g0 = jnp.zeros((1, X, X, T0, 3)), jnp.zeros((1, X, X, 2))
    model = FlaxFNO2dAux(num_channels=3, modes1=3, modes2=3, width=6, initial_step=T0)
    return to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(7), x0, g0, x0, g0)["params"])


def _same_history(got, want, rtol):
    assert [h["epoch"] for h in got.history] == [h["epoch"] for h in want.history]
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=rtol)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=rtol)


def _rel_trees(got, want, tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        err = np.abs(np.asarray(have) - leaf).max() / np.abs(leaf).max()
        assert err <= tol, f"{jax.tree_util.keystr(path)} off by {err:.3e} of its max"


@pytest.mark.parametrize("schedule,epochs", [("block", 3), ("interleave", 4), ("cyclic", 3)])
def test_fno_rotation_matches_jax(folders, tmp_path, schedule, epochs):
    kw = _fno_kw(folders["mixed"], resident_rotate=2, resident_rotate_schedule=schedule,
                 epochs=epochs)
    init = _fno_init()
    with precision("highest"):
        want = jax_run_training(run_dir=str(tmp_path / "j"), **kw)
        got = run_training(run_dir=str(tmp_path / "t"), init_params=init, device="cpu", **kw)
    assert len(got.history) == epochs
    _same_history(got, want, 1e-4)
    _rel_trees(got.params, to_numpy_tree(want.params), 5e-4)


def test_identical_slices_train_like_one_slice(folders, tmp_path):
    """JAX's oracle: the rotated run on a pool of two identical slices and
    the unrotated run on one slice see the same batches from the same
    generator, so the whole history agrees."""
    init = _fno_init()
    rot = run_training(run_dir=str(tmp_path / "a"), init_params=init, device="cpu",
                       **_fno_kw(folders["same"], resident_rotate=2, epochs=3))
    one = run_training(run_dir=str(tmp_path / "b"), init_params=init, device="cpu",
                       **_fno_kw(folders["same"], train_subsample=(1, 1, 1), epochs=3))
    assert len(rot.history) == 3
    _same_history(rot, one, 1e-6)


def test_resume_into_the_second_slice_matches_jax(folders, tmp_path):
    """Two cyclic epochs write the best checkpoint at epoch 1; the resumed
    run (4 epochs) starts there, in slice 1, in both packages."""
    init = _fno_init()
    with precision("highest"):
        for epochs, resume in ((2, False), (4, True)):
            kw = _fno_kw(folders["mixed"], resident_rotate=2, resident_rotate_schedule="cyclic",
                         epochs=epochs, continue_training=resume)
            want = jax_run_training(run_dir=str(tmp_path / "j"), **kw)
            got = run_training(run_dir=str(tmp_path / "t"), init_params=init, device="cpu",
                               **kw)
            _same_history(got, want, 1e-4)
    assert got.history[0]["epoch"] == 1  # epoch 1 of the cyclic schedule: slice 1
    _rel_trees(got.params, to_numpy_tree(want.params), 5e-4)


@pytest.mark.parametrize("schedule", ["block", "interleave", "cyclic"])
def test_transformer_rotation_matches_jax(folders, tmp_path, schedule):
    """The VideoMAE baseline (12^2 frames, patch 6) on two slices of two
    trajectories each, four epochs."""
    kw = dict(base_path=folders["mixed"], dataset_family="ns", if_aux=False,
              train_subsample=(2, 2, 2), test_range=(250, 251), img_size=X, patch_size=6,
              tubelet_size=2, in_chans=3, encoder_embed_dim=12, encoder_depth=1,
              encoder_num_heads=2, decoder_embed_dim=12, decoder_depth=1,
              decoder_num_heads=1, initial_step=4, batch_size=4, epochs=4, bf16=False,
              log_every=0, seed=5, resident_rotate=2, resident_rotate_schedule=schedule,
              model_name="r")
    model = FlaxVMAE(img_size=X, patch_size=6, tubelet_size=2, in_chans=3, num_frames=4,
                     encoder_dim=12, encoder_depth=1, encoder_heads=2, decoder_dim=12,
                     decoder_depth=1, decoder_heads=1)
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(5),
                                             jnp.zeros((1, 4, X, X, 3)))["params"])
    want = jax_run_tf(run_dir=str(tmp_path / "j"), **kw)
    got = run_transformer_training(run_dir=str(tmp_path / "t"), init_params=init,
                                   device="cpu", **kw)
    assert len(got.history) == 4
    _same_history(got, want, 1e-4)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=1e-3, atol=1e-6,
                       what="trained params")
