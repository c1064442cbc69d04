"""Port train/fast_step.py vs the JAX build_fast_baseline_step: three steps
from the same theta on the same data and index batches; loss, grad norm
and parameters compared after each step.  The K-step scan against K steps
and against the JAX scan."""

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
        tstep, _ = tfs.build_fast_baseline_step(MODES, T0, spec_t, LR, TOTAL)
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


def test_step_scan_equals_single_steps(setup):
    """step_scan over a (3, B, 2) chunk gives exactly what three calls of
    step give: the same losses, grad norms, parameters and moments."""
    data, grid2, idxs, params = setup
    data_t, grid_t = torch.from_numpy(data), torch.from_numpy(grid2)
    chunk = torch.from_numpy(np.stack(idxs)).long()
    with precision("highest"):
        theta, spec = tfs.fast_state_from_tree(params, MODES, "cpu")
        step, step_scan = tfs.build_fast_baseline_step(MODES, T0, spec, LR, TOTAL)
        theta_a, opt_a, losses_a, gns_a = theta.clone(), tfs.init_opt(theta), [], []
        for idx in chunk:
            theta_a, opt_a, loss, gn = step(theta_a, opt_a, data_t, grid_t, idx)
            losses_a.append(loss)
            gns_a.append(gn)
        theta_b, opt_b, losses_b, gns_b = step_scan(theta.clone(), tfs.init_opt(theta), data_t,
                                                    grid_t, chunk)
    assert losses_b.shape == gns_b.shape == (3,) and opt_b.count == opt_a.count == 3
    assert torch.equal(losses_b, torch.stack(losses_a))
    assert torch.equal(gns_b, torch.stack(gns_a))
    assert torch.equal(theta_b, theta_a)
    assert torch.equal(opt_b.m, opt_a.m) and torch.equal(opt_b.v, opt_a.v)


def test_step_scan_matches_jax_scan(setup):
    """The port's step_scan and JAX's from the same tree and chunk, at the
    three-step test's bounds."""
    data, grid2, idxs, params = setup
    chunk = np.stack(idxs)
    with precision("highest"):
        theta_j, spec_j = jfs.fast_state_from_tree(params, MODES)
        _, jscan = jfs.build_fast_baseline_step(MODES, T0, spec_j, LR, TOTAL)
        theta_j, _, losses_j, gns_j = jscan(theta_j, jfs.init_opt(theta_j), jnp.asarray(data),
                                            jnp.asarray(grid2), jnp.asarray(chunk))
        theta_t, spec_t = tfs.fast_state_from_tree(params, MODES, "cpu")
        _, tscan = tfs.build_fast_baseline_step(MODES, T0, spec_t, LR, TOTAL)
        theta_t, _, losses_t, gns_t = tscan(theta_t, tfs.init_opt(theta_t),
                                            torch.from_numpy(data), torch.from_numpy(grid2),
                                            torch.from_numpy(chunk).long())
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-4)
    np.testing.assert_allclose(gns_t.numpy(), np.asarray(gns_j), rtol=1e-3)
    want = to_numpy_tree(jfs.tree_from_fast_state(theta_j, spec_j, MODES, params))
    assert_trees_close(tfs.tree_from_fast_state(theta_t, spec_t, MODES), want, rtol=5e-3,
                       atol=1e-5, what="params after the scan")


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


def test_gather_and_step_clamp_past_the_end_like_jax(setup):
    """12 frames, t0 = 10, initial_step 3: the JAX gather clamps frames past
    the end, so x takes frames [10, 11, 11] and y frame 11.  The port's
    fast_gather gives the same values, and one fused step on such rows the
    three-step test's loss and grad norm."""
    _, grid2, _, params = setup
    data = np.random.default_rng(4).normal(size=(2, 12, X, Y, C)).astype(np.float32)
    idx = np.array([[0, 10], [1, 11]], np.int32)
    x, y = tfs.fast_gather(torch.from_numpy(data), torch.from_numpy(idx).long(), T0)
    xj, yj = jfs.fast_gather(jnp.asarray(data), jnp.asarray(idx), T0)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(x.numpy()[0], np.moveaxis(data[0, [10, 11, 11]], -1, 1))
    np.testing.assert_array_equal(y.numpy()[0], np.moveaxis(data[0, 11], -1, 0))
    with precision("highest"):
        theta_j, spec_j = jfs.fast_state_from_tree(params, MODES)
        jstep, _ = jfs.build_fast_baseline_step(MODES, T0, spec_j, LR, TOTAL)
        _, _, loss_j, gn_j = jstep(theta_j, jfs.init_opt(theta_j), jnp.asarray(data),
                                   jnp.asarray(grid2), jnp.asarray(idx))
        theta_t, spec_t = tfs.fast_state_from_tree(params, MODES, "cpu")
        tstep, _ = tfs.build_fast_baseline_step(MODES, T0, spec_t, LR, TOTAL)
        _, _, loss_t, gn_t = tstep(theta_t, tfs.init_opt(theta_t), torch.from_numpy(data),
                                   torch.from_numpy(grid2), torch.from_numpy(idx).long())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-3)
