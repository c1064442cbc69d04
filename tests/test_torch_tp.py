"""Tensor parallelism in the port (``sciml_pde_torch/parallel/tp.py``)
against the JAX package's (``tests/test_tp.py``'s model and placements):
two spawned CPU processes on a gloo group make a mesh of ``model=2``, run
the column-parallel FNO2d forward from the same flax tree, and back-propagate
``sum(out * cot)``.  Every rank's output equals JAX's replicated FNO2d within
2e-5 (JAX's own bound for its TP forward), and every shard's gradient is
its block of JAX's replicated gradient within 1e-5 of that leaf's largest
magnitude.  ``highest`` products in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sciml_pde_torch import parallel
from sciml_pde_torch.parallel.tp import fno_tp_rules

from _torch_dist_worker import spawn, tp_forward
from _torch_parity import few_threads, precision, to_numpy_tree  # noqa: F401


def _setup():
    from sciml_pde_tpu.models import FNO2d

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 16, 4, 2)).astype(np.float32)
    g = rng.uniform(size=(4, 16, 16, 2)).astype(np.float32)
    model = FNO2d(num_channels=2, modes1=4, modes2=4, width=8, initial_step=4)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(g))["params"]
    return model, params, x, g


def test_tp_sharding_placements():
    """JAX's placements on a 4 x 2 mesh, and a whole leaf replicated where
    the model axis does not divide it."""
    mesh = parallel.make_mesh(data=4, model=2, devices=list(range(8)))
    _, params, _, _ = _setup()
    assert fno_tp_rules(("backbone", "conv0", "w1"), params["backbone"]["conv0"]["w1"],
                        mesh).spec[2] == "model"
    assert fno_tp_rules(("backbone", "fc0", "Dense_0", "kernel"),
                        params["backbone"]["fc0"]["Dense_0"]["kernel"],
                        mesh).spec == (None, "model")
    assert fno_tp_rules("backbone/fc1/Dense_0/bias", np.zeros(128), mesh).spec == ("model",)
    assert fno_tp_rules("fc2/Dense_0/kernel", np.zeros((128, 3)), mesh).spec == ()
    assert fno_tp_rules("backbone/conv0/w1", np.zeros((2, 8, 8, 4, 4)),
                        parallel.make_mesh(data=8, devices=list(range(8)))).spec == ()


def test_one_rank_refuses_a_model_axis_as_jax():
    from sciml_pde_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError, match="1 devices not divisible by model=2") as want:
        jax_make_mesh(model=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        parallel.make_mesh(model=2)
    assert str(got.value) == str(want.value)


def test_tp_forward_and_gradients_match_replicated_jax():
    model, params, x, g = _setup()
    cot = np.random.default_rng(1).normal(size=(4, 16, 16, 1, 2)).astype(np.float32)
    with precision("highest"):
        y = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(g))
        grads = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, jnp.asarray(x),
                                                       jnp.asarray(g)) * cot))(params)
    tree = to_numpy_tree(params)
    res = spawn(tp_forward, 2, tree, x, g, cot)
    want = to_numpy_tree(grads)
    for rank, r in enumerate(res):
        assert r["shape"] == {"data": 1, "model": 2} and r["model_rank"] == rank
        np.testing.assert_allclose(r["out"], np.asarray(y), atol=2e-5)
        n_split = 0

        def check(got, ref, path):
            nonlocal n_split
            if isinstance(ref, dict):
                for k in ref:
                    check(got[k], ref[k], path + (k,))
                return
            gr, spec = got
            if "model" in spec:
                axis, n_split = spec.index("model"), n_split + 1
                size = ref.shape[axis] // 2
                ref = np.take(ref, np.arange(rank * size, (rank + 1) * size), axis=axis)
            err = np.abs(gr - ref).max() / np.abs(ref).max()
            assert gr.shape == ref.shape and err <= 1e-5, ("/".join(path), err)
        check(r["grads"], want, ())
        assert n_split == 22  # fc0, fc1, fc2 (kernel, bias); 4 x (w1, w2, kernel, bias)
