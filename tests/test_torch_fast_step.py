"""Port train/fast_step.py vs the JAX build_fast_baseline_step: three steps
from the same theta on the same data and index batches; loss, grad norm
and parameters compared after each step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.train import fast_step as jfs
from sciml_pde_torch.train import fast_step as tfs

from _torch_parity import assert_trees_close, precision, to_numpy_tree

N, T, X, Y, C = 3, 8, 16, 16, 2
MODES, WIDTH, T0 = 4, 8, 3
LR, TOTAL, B = 1e-3, 50, 2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N, T, X, Y, C)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, X, dtype=np.float32),
                         np.linspace(0, 1, Y, dtype=np.float32), indexing="ij")
    grid2 = np.ascontiguousarray(np.stack([gx, gy], 0))
    idxs = [np.stack([rng.integers(0, N, B), rng.integers(0, T - T0 - 1, B)], 1).astype(np.int32)
            for _ in range(3)]
    params = to_numpy_tree(
        FlaxFNO2d(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH, initial_step=T0)
        .init(jax.random.PRNGKey(0), jnp.zeros((1, X, Y, T0, C)), jnp.zeros((1, X, Y, 2)))
        ["params"])
    return data, grid2, idxs, params


def test_fast_step_matches_jax_three_steps(setup):
    data, grid2, idxs, params = setup
    with precision("highest"):
        theta_j, spec_j = jfs.fast_state_from_tree(params, MODES)
        jstep, _ = jfs.build_fast_baseline_step(MODES, T0, spec_j, LR, TOTAL)
        opt_j = jfs.init_opt(theta_j)
        theta_t, spec_t = tfs.fast_state_from_tree(params, MODES, "cpu")
        tstep = tfs.build_fast_baseline_step(MODES, T0, spec_t, LR, TOTAL)
        opt_t = tfs.init_opt(theta_t)
        data_t, grid_t = torch.from_numpy(data), torch.from_numpy(grid2)
        for k, idx in enumerate(idxs):
            theta_j, opt_j, loss_j, gn_j = jstep(theta_j, opt_j, jnp.asarray(data),
                                                 jnp.asarray(grid2), jnp.asarray(idx))
            theta_t, opt_t, loss_t, gn_t = tstep(theta_t, opt_t, data_t, grid_t,
                                                 torch.from_numpy(idx).long())
            np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                       err_msg=f"loss at step {k}")
            np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-3,
                                       err_msg=f"grad norm at step {k}")
            want = to_numpy_tree(jfs.tree_from_fast_state(theta_j, spec_j, MODES, params))
            got = tfs.tree_from_fast_state(theta_t, spec_t, MODES)
            assert_trees_close(got, want, rtol=5e-3, atol=1e-5, what=f"params at step {k}")
    assert opt_t.count == 3


def test_optimizer_update_clips_on_global_norm():
    """A gradient of norm 100 is scaled to max(5, 0.1*100) = 10 before the
    weight decay and Adam."""
    theta = torch.zeros(4)
    g = torch.tensor([100.0, 0.0, 0.0, 0.0])
    opt = tfs.init_opt(theta)
    theta, opt, g_norm = tfs.optimizer_update(theta, opt, g, lambda c: 1.0)
    assert float(g_norm) == pytest.approx(100.0)
    assert float(opt.m[0]) == pytest.approx(0.1 * 10.0)
    assert opt.count == 1


def test_flatten_unflatten_roundtrip(setup):
    params = setup[3]
    theta, spec = tfs.fast_state_from_tree(params, MODES, "cpu")
    assert theta.numel() == spec.total
    back = tfs.flatten_params(tfs.unflatten_params(theta, spec))
    assert torch.equal(back, theta)
