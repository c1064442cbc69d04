"""The port's point-set trainers (``sciml_pde_torch/comparisons/
pointset_bvp.py``) against the JAX package's: the synthetic generators and
``standardize_features`` bit for bit; ``masked_pointwise_loss``;
``run_pointset_training`` under both recipes (optax ``adamw`` on a cosine;
the reference's clip, weight decay, AMSGrad and warmup-cosine) and
``run_airfoil_training``, from one flax tree: the first 3 logged losses
within 1e-4 relative, and the held-out evaluations of the trained trees
within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_losses_close, few_threads, logged, to_numpy_tree  # noqa: F401


def test_generators_and_scaling_equal_jax():
    from sciml_pde_tpu.comparisons import pointset_bvp as jp
    from sciml_pde_torch.comparisons import pointset_bvp as tp

    for fn, args in ((jp.synthetic_electrostatics, (3, 5, 32)),
                     (jp.synthetic_vortex_sheet, (4, 3, 20, 6))):
        want, got = fn(*args), getattr(tp, fn.__name__)(*args)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a, b = jp.synthetic_electrostatics(0, 4, 32), jp.synthetic_electrostatics(1, 2, 32)
    for w, g in zip(jp.standardize_features(a, b), tp.standardize_features(a, b)):
        for k in (w if isinstance(w, dict) else range(len(w))):
            np.testing.assert_array_equal(g[k], w[k])
    rng = np.random.default_rng(0)
    pred, tgt = rng.normal(size=(2, 32, 2)), rng.normal(size=(2, 32, 2))
    for p in (1, 2):
        np.testing.assert_allclose(
            float(tp.masked_pointwise_loss(torch.as_tensor(pred), torch.as_tensor(tgt),
                                           torch.as_tensor(a["pad_mask"][:2]), p)),
            float(jp.masked_pointwise_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                           jnp.asarray(a["pad_mask"][:2]), p)), rtol=1e-6)


@pytest.mark.parametrize("recipe", ["adamw", "reference"])
def test_pointset_training_matches_jax(tmp_path, recipe):
    from sciml_pde_tpu.comparisons import pointset_bvp as jp
    from sciml_pde_tpu.models.oformer import OFormerIrreg2D
    from sciml_pde_torch.comparisons import pointset_bvp as tp
    from sciml_pde_torch.models.oformer import OFormerIrreg2D as TIrreg

    train, test = jp.synthetic_electrostatics(0, 12, 32), jp.synthetic_electrostatics(1, 4, 32)
    kw = dict(latent_channels=16, heads=1, depth=2, batch_size=4, epochs=1, log_every=1,
              seed=6, reference_recipe=recipe == "reference",
              clip=None if recipe == "reference" else 1.0)
    want = jp.run_pointset_training(train, run_dir=str(tmp_path / "jax"), **kw)
    jm = OFormerIrreg2D(input_channels=train["features"].shape[-1], latent_channels=16)
    a = {k: jnp.asarray(v[:1]) for k, v in train.items()}
    tree = to_numpy_tree(jm.init(jax.random.PRNGKey(6), a["features"], a["coords"],
                                 a["pad_mask"], a["bound_mask"])["params"])
    got = tp.run_pointset_training(train, run_dir=str(tmp_path / "torch"), device="cpu",
                                   init_params=tree, **kw)
    assert_losses_close(logged(tmp_path / "torch", "pointset_bvp", "loss"),
                        logged(tmp_path / "jax", "pointset_bvp", "loss"))
    ev_w = jp.evaluate_pointset(jm, want.params, test)
    ev_g = tp.evaluate_pointset(TIrreg(train["features"].shape[-1], 16), got.params, test,
                                device="cpu")
    for k in ev_w:
        np.testing.assert_allclose(ev_g[k], ev_w[k], rtol=1e-4, err_msg=k)


def test_airfoil_training_matches_jax(tmp_path):
    from sciml_pde_tpu.comparisons import pointset_bvp as jp
    from sciml_pde_tpu.models.oformer import OFormerIrregST2D
    from sciml_pde_torch.comparisons import pointset_bvp as tp

    train, test = jp.synthetic_vortex_sheet(0, 2, 24, 8), jp.synthetic_vortex_sheet(1, 1, 24, 8)
    kw = dict(time_window=4, forward_steps=2, emb_dim=16, latent_channels=16, depth=2,
              batch_size=2, epochs=1, log_every=1, seed=6)
    want = jp.run_airfoil_training(train, run_dir=str(tmp_path / "jax"), **kw)
    jm = OFormerIrregST2D(input_channels=6, out_channels=4, time_window=4, emb_dim=16,
                          latent_channels=16, depth=2)
    tree = to_numpy_tree(jm.init(jax.random.PRNGKey(6), jnp.zeros((1, 4, 24, 6)),
                                 jnp.zeros((1, 24), jnp.int32), jnp.zeros((1, 24, 2)),
                                 2)["params"])
    got = tp.run_airfoil_training(train, run_dir=str(tmp_path / "torch"), device="cpu",
                                  init_params=tree, **kw)
    assert_losses_close(logged(tmp_path / "torch", "pointset_airfoil", "l1"),
                        logged(tmp_path / "jax", "pointset_airfoil", "l1"))
    ev = dict(time_window=4, forward_steps=2, emb_dim=16, latent_channels=16, depth=2)
    ev_w = jp.evaluate_airfoil(want.params, test, **ev)
    ev_g = tp.evaluate_airfoil(got.params, test, device="cpu", **ev)
    for k in ev_w:
        np.testing.assert_allclose(ev_g[k], ev_w[k], rtol=1e-4, err_msg=k)
