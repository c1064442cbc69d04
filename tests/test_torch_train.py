"""Port train/fno_train.py vs JAX run_training(fast_step=True): one tiny DR
epoch from the same initial weights and the same batch order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.train.fno_train import run_training
from sciml_pde_torch.utils.checkpoint import restore_checkpoint

from _torch_parity import assert_trees_close, precision, to_numpy_tree

S, X, C = 12, 16, 2
COMMON = dict(if_aux=False, train_subsample=(4, 2, 6), modes=4, width=8, initial_step=5,
              rollout_test=1, num_channels=C, batch_size=4, epochs=1, learning_rate=2e-3,
              log_every=0, seed=3)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("dr_train")
    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, X, dtype=np.float32)
    for s in range(10):
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(S, X, X, C)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, S, dtype=np.float32))
    return str(d) + "/"


def test_one_epoch_matches_jax_fast_step(folder, tmp_path):
    # the JAX trainer initialises from PRNGKey(seed) at these shapes
    init = to_numpy_tree(FlaxFNO2d(num_channels=C, modes1=4, modes2=4, width=8,
                                   initial_step=5).init(
        jax.random.PRNGKey(COMMON["seed"]), jnp.zeros((1, X, X, 5, C)),
        jnp.zeros((1, X, X, 2)))["params"])
    with precision("highest"):
        want = jax_run_training(base_path=folder, fast_step=True, run_dir=str(tmp_path / "j"),
                                model_name="j", **COMMON)
        got = run_training(base_path=folder, run_dir=str(tmp_path / "t"), model_name="t",
                           init_params=init, device="cpu",
                           **{k: v for k, v in COMMON.items() if k != "if_aux"})
    assert len(got.history) == len(want.history) == 1
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-3)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-3)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=5e-3, atol=1e-5,
                       what="trained params")

    ck = restore_checkpoint(tmp_path / "t" / "t_ckpt.pt")
    assert ck["meta"]["epoch"] == 0
    assert ck["params"]["backbone"]["conv0"]["w1"].shape == (2, 8, 8, 4, 4)
    assert ck["params"]["fc2"]["Dense_0"]["kernel"].shape == (128, C)


def test_continue_training_resumes_from_checkpoint(folder, tmp_path):
    kw = {k: v for k, v in COMMON.items() if k != "if_aux"}
    run_training(base_path=folder, run_dir=str(tmp_path), model_name="r", device="cpu", **kw)
    kw["epochs"] = 2
    res = run_training(base_path=folder, run_dir=str(tmp_path), model_name="r",
                       device="cpu", continue_training=True, **kw)
    # the JAX trainer resumes at the checkpoint's (best) epoch
    assert [h["epoch"] for h in res.history] == [0, 1]
    assert all(np.isfinite(h["val_loss"]) for h in res.history)
    assert restore_checkpoint(tmp_path / "r_ckpt.pt")["opt_state"]["count"] > 0


@pytest.mark.parametrize("bad", [dict(if_aux=True), dict(training_type="autoregressive"),
                                 dict(rollout_test=2), dict(scheduler="step")])
def test_unsupported_configs_raise(tmp_path, bad):
    with pytest.raises(ValueError, match="fused_step"):
        run_training(base_path=str(tmp_path), device="cpu", **bad)
