"""Port train/transformer_train.py vs the JAX package on the DR family:
one tiny epoch of run_transformer_training from the same initial weights
and the same batch order, at a shape the attention shape rule sends to
jnp_attention."""

import jax
import jax.numpy as jnp
import numpy as np

from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models.transformer import VideoMAEOperator as FlaxVideoMAE
from sciml_pde_tpu.train import transformer_train as jtt
from sciml_pde_torch.ops import attention as ta
from sciml_pde_torch.train import transformer_train as ttt

from _torch_parity import assert_trees_close, to_numpy_tree


def test_dr_epoch_takes_the_jnp_path_and_matches_jax(tmp_path, monkeypatch):
    """dataset_family="dr" with the DR recipe's tubelet 1: 16^2, patch 8, 5
    frames give 20 tokens, which the shape rule sends to jnp_attention in
    both packages.  f32, batch 8, 28 windows: three steps."""
    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, 16, dtype=np.float32)
    for s in range(10):
        write_seed_group(tmp_path / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(12, 16, 16, 2)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, 12, dtype=np.float32))
    common = dict(base_path=str(tmp_path) + "/", dataset_family="dr", if_aux=False,
                  train_subsample=(4, 2, 6), img_size=16, patch_size=8, tubelet_size=1,
                  in_chans=2, encoder_embed_dim=16, encoder_depth=1, encoder_num_heads=2,
                  decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2,
                  initial_step=5, batch_size=8, epochs=1, bf16=False, log_every=0, seed=2,
                  loss_type="nrmse", fourier_weight=0.1)
    model = FlaxVideoMAE(img_size=16, patch_size=8, tubelet_size=1, in_chans=2, num_frames=5,
                         encoder_dim=16, encoder_depth=1, encoder_heads=2, decoder_dim=16,
                         decoder_depth=1, decoder_heads=2)
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(2),
                                             jnp.zeros((1, 5, 16, 16, 2)))["params"])
    want = jtt.run_transformer_training(run_dir=str(tmp_path / "j"), model_name="j", **common)
    fused = []
    real = ta._FlashCore.apply
    monkeypatch.setattr(ta._FlashCore, "apply", lambda *a: fused.append(1) or real(*a))
    got = ttt.run_transformer_training(run_dir=str(tmp_path / "t"), model_name="t",
                                       init_params=init, device="cpu", **common)
    assert not fused
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[0][key], want.history[0][key], rtol=1e-4)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=1e-3, atol=1e-6,
                       what="trained params")
