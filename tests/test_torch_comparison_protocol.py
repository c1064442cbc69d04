"""The port's DR rollout protocol
(``sciml_pde_torch/comparisons/oformer_dr2d.py::run_rollout_protocol``:
one encode, a latent rollout under remat, standardised arrays) against the
JAX package's from one flax tree: the first 3 logged losses and the five
evaluation numbers within 1e-4 relative; ``_protocol_arrays`` equal to
JAX's bit for bit.  OFormer: the Hyena hybrid's JAX step takes some 45 s to
compile on the CPU, so its trainer is held to the CPU on the card
(``chip_smoke.py`` 21b) and its classes to JAX (``test_torch_oformer.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dr_files import write_dr
from _torch_parity import assert_losses_close, few_threads, logged, to_numpy_tree  # noqa: F401

KW = dict(in_seq_len=4, out_seq_len=3, spatial_down=2, channel=0, train_subsample=3,
          batch_size=1, epochs=1, in_emb_dim=16, latent_channels=16, heads=2, depth=2,
          log_every=1, seed=16)


def _init_tree(model_type: str):
    from sciml_pde_tpu.models.hyena import HyenaOFormer2D
    from sciml_pde_tpu.models.oformer import OFormer2D

    kw = dict(input_channels=KW["in_seq_len"] + 2, out_channels=1, in_emb_dim=16,
              latent_channels=16, heads=2, depth=2, out_steps=1, remat=True)
    m = (HyenaOFormer2D(**kw, branches=8, l_max=64) if model_type == "hyena"
         else OFormer2D(**kw, propagator_depth=1))
    params = m.init(jax.random.PRNGKey(KW["seed"]), jnp.zeros((1, 64, kw["input_channels"])),
                    jnp.zeros((1, 64, 2)))["params"]
    return to_numpy_tree(params)


def test_protocol_arrays_equal_jax(tmp_path):
    from sciml_pde_tpu.comparisons.oformer_dr2d import _protocol_arrays as jarr
    from sciml_pde_torch.comparisons.oformer_dr2d import _protocol_arrays as tarr

    data = write_dr(tmp_path)
    kw = dict(train_subsample=5, extra_train_files=None, in_seq_len=4, out_seq_len=3,
              spatial_down=2, channel=None)
    want, got = jarr(data, **kw), tarr(data, **kw)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("model_type", ["oformer"])
def test_rollout_protocol_matches_jax(tmp_path, model_type):
    from sciml_pde_tpu.comparisons import oformer_dr2d as jc
    from sciml_pde_torch.comparisons import oformer_dr2d as tc

    data = write_dr(tmp_path)
    want, _ = jc.run_rollout_protocol(base_path=data, model_type=model_type,
                                      run_dir=str(tmp_path / "jax"), **KW)
    got, tree = tc.run_rollout_protocol(base_path=data, model_type=model_type,
                                        run_dir=str(tmp_path / "torch"), device="cpu",
                                        init_params=_init_tree(model_type), **KW)
    assert_losses_close(logged(tmp_path / "torch", "oformer_dr_rollout", "train_rel_l2"),
                        logged(tmp_path / "jax", "oformer_dr_rollout", "train_rel_l2"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        _init_tree(model_type))
