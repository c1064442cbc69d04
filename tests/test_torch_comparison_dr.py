"""The port's 1-step DR comparison trainer
(``sciml_pde_torch/comparisons/oformer_dr2d.py::run_comparison_training``)
against the JAX package's: the same DR file, seed and flax tree (JAX's
``init`` from ``PRNGKey(seed)``, handed to the port as ``init_params``),
the first 3 logged losses within 1e-4 relative, and ``evaluate_comparison``
of the trained trees within 1e-4.  OFormer here; the Hyena hybrid, whose
JAX step takes 45 s to compile on the CPU, through the rollout protocol
(``test_torch_comparison_protocol.py``) and its classes
(``test_torch_oformer.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dr_files import write_dr
from _torch_parity import assert_losses_close, few_threads, logged, to_numpy_tree  # noqa: F401

KW = dict(train_subsample=4, initial_step=4, num_channels=2, batch_size=4, epochs=1,
          in_emb_dim=16, latent_channels=16, heads=2, depth=2, log_every=1, seed=16)


def _init_tree(model_type: str):
    from sciml_pde_tpu.models.hyena import HyenaOFormer2D
    from sciml_pde_tpu.models.oformer import OFormer2D

    cin = KW["initial_step"] * 2 + 2
    dims = dict(in_emb_dim=16, latent_channels=16, heads=2, depth=2)
    if model_type == "hyena":
        m = HyenaOFormer2D(input_channels=cin, out_channels=2, branches=8, l_max=256, **dims)
    else:
        m = OFormer2D(input_channels=cin, out_channels=2, out_steps=1, propagator_depth=1, **dims)
    params = m.init(jax.random.PRNGKey(KW["seed"]), jnp.zeros((1, 256, cin)),
                    jnp.zeros((1, 256, 2)))["params"]
    return to_numpy_tree(params)


@pytest.mark.parametrize("model_type", ["oformer"])
def test_comparison_training_matches_jax(tmp_path, model_type):
    from sciml_pde_tpu.comparisons import oformer_dr2d as jc
    from sciml_pde_torch.comparisons import oformer_dr2d as tc

    data = write_dr(tmp_path)
    want = jc.run_comparison_training(base_path=data, model_type=model_type,
                                      run_dir=str(tmp_path / "jax"), **KW)
    got = tc.run_comparison_training(base_path=data, model_type=model_type,
                                     run_dir=str(tmp_path / "torch"), device="cpu",
                                     init_params=_init_tree(model_type), **KW)
    assert_losses_close(logged(tmp_path / "torch", "oformer_dr", "train_rel_l2"),
                        logged(tmp_path / "jax", "oformer_dr", "train_rel_l2"))
    ev_w = jc.evaluate_comparison(want.model, want.params, want.test_w, 4, 2)
    ev_g = tc.evaluate_comparison(got.model, got.params, got.test_w, 4, 2)
    np.testing.assert_allclose(ev_g["rel_l2_by_step"], ev_w["rel_l2_by_step"], rtol=1e-4)
    np.testing.assert_allclose(ev_g["accumulated_mse"], ev_w["accumulated_mse"], rtol=1e-4)
