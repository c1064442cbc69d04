"""Port models/fno.py FNO2d vs the flax FNO2d: forward and gradients, with
weights carried across by utils/weights.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import assert_trees_close, precision, to_numpy_tree

B, X, Y, T, CC = 2, 16, 16, 3, 2
WIDTH, MODES = 8, 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, X, Y, T, CC)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, X, dtype=np.float32),
                         np.linspace(0, 1, Y, dtype=np.float32), indexing="ij")
    grid = np.broadcast_to(np.stack([gx, gy], -1)[None], (B, X, Y, 2)).copy()
    flax_model = FlaxFNO2d(num_channels=CC, modes1=MODES, modes2=MODES, width=WIDTH,
                           initial_step=T)
    params = to_numpy_tree(flax_model.init(jax.random.PRNGKey(1), x, grid)["params"])
    model = FNO2d(CC, MODES, MODES, WIDTH, T)
    model.load_state_dict(flax_to_state_dict(params))
    cot = rng.normal(size=(B, X, Y, 1, CC)).astype(np.float32)
    return flax_model, params, model, x, grid, cot


def test_state_dict_roundtrip(setup):
    _, params, model, *_ = setup
    assert_trees_close(state_dict_to_flax(model.state_dict()), params, 0, 0, "roundtrip")


@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_forward_matches_flax(setup, impl):
    flax_model, params, model, x, grid, _ = setup
    with precision("highest"):
        want = np.asarray(flax_model.apply({"params": params}, x, grid))
        got = model(torch.from_numpy(x), torch.from_numpy(grid), impl=impl).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_grads_match_jax_grad(setup):
    flax_model, params, model, x, grid, cot = setup
    with precision("highest"):
        g_flax = jax.grad(lambda p: jnp.sum(flax_model.apply({"params": p}, x, grid) * cot))(params)
        model.zero_grad()
        (model(torch.from_numpy(x), torch.from_numpy(grid)) * torch.from_numpy(cot)).sum().backward()
    g_port = state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})
    assert_trees_close(g_port, to_numpy_tree(g_flax), 5e-3, 1e-4, "grad")
