"""Port train/optim.py (adaptive clip, the production optimizer) and
train/fno_train.py::build_baseline_step (with its ``scan`` and ``xy``
variants) vs the JAX package, on the same numpy-seeded inputs, f32 products
in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.train.fno_train import build_baseline_step as jax_build_step
from sciml_pde_tpu.train.optim import adaptive_clip as jax_adaptive_clip
from sciml_pde_tpu.train.optim import make_optimizer as jax_make_optimizer
from sciml_pde_torch.data.windows import gather_windows
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.train.fno_train import build_baseline_step
from sciml_pde_torch.train.optim import adaptive_clip, make_optimizer
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import precision, to_numpy_tree

N, S, X, C, T0, WIDTH, MODES, BATCH = 3, 12, 16, 2, 3, 8, 4, 2


def _grads(norm: float, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    total = np.sqrt(sum(np.sum(v * v) for v in g.values()))
    return {k: (v * norm / total).astype(np.float32) for k, v in g.items()}


@pytest.mark.parametrize("norm", [1.0, 20.0, 100.0], ids=["below_5", "5_to_50", "above_50"])
def test_adaptive_clip_matches_jax(norm):
    """Below 5 unchanged; from 5 to 50 clipped to 5; above 50 to 0.1 ||g||."""
    g = _grads(norm)
    clipped, g_norm = adaptive_clip([torch.from_numpy(g[k]) for k in ("a", "b")])
    want, _ = jax_adaptive_clip().update({k: jnp.asarray(v) for k, v in g.items()}, None)
    np.testing.assert_allclose(float(g_norm), norm, rtol=1e-6)
    for t, k in zip(clipped, ("a", "b")):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    new_norm = float(torch.linalg.vector_norm(torch.cat([t.reshape(-1) for t in clipped])))
    np.testing.assert_allclose(new_norm, min(norm, max(5.0, 0.1 * norm)), rtol=1e-5)


@pytest.mark.parametrize("scheduler", ["cosine", "step"])
def test_make_optimizer_matches_optax(scheduler):
    """Five updates with gradients in every clipping regime: the parameters
    after each within 1e-6 of the largest magnitude."""
    rng = np.random.default_rng(1)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_make_optimizer(1e-2, 5, scheduler, 1e-4, scheduler_step=2, scheduler_gamma=0.5)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = make_optimizer(pt, 1e-2, 5, scheduler, 1e-4, scheduler_step=2, scheduler_gamma=0.5)
    for i, norm in enumerate([1.0, 20.0, 100.0, 3.0, 60.0]):
        g = _grads(norm, seed=10 + i)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        g_norm = opt.step(pt, {k: torch.from_numpy(v) for k, v in g.items()})
        np.testing.assert_allclose(float(g_norm), norm, rtol=1e-6)
        for k in p0:
            want = np.asarray(pj[k])
            np.testing.assert_allclose(pt[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {i} param {k}")
    assert opt.count == 5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N, S, X, X, C)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, X, dtype=np.float32),
                         np.linspace(0, 1, X, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)
    # t0 up to S - T0 - 1: the autoregressive windows run past the end
    idxs = [np.stack([rng.integers(0, N, BATCH), rng.integers(0, S - T0, BATCH)],
                     axis=1).astype(np.int32) for _ in range(3)]
    idxs[-1][:, 1] = S - T0 - 1
    flax_model = FlaxFNO2d(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH,
                           initial_step=T0)
    tree = to_numpy_tree(flax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, X, X, T0, C)),
                                         jnp.zeros((1, X, X, 2)))["params"])
    return data, grid, idxs, flax_model, tree


def _port_step(tree, training_type, t_train):
    model = FNO2d(C, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    params = dict(model.named_parameters())
    opt = make_optimizer(params, LR, 10)
    step, val = build_baseline_step(model, opt, T0, 1, training_type, t_train)
    return params, step, val


def _assert_params_close(params, pj):
    """The port's parameters against a JAX tree, within 1e-5 of the largest
    parameter magnitude."""
    got = state_dict_to_flax(params)
    want = jax.tree_util.tree_leaves_with_path(to_numpy_tree(pj))
    scale = max(np.abs(leaf).max() for _, leaf in want)
    for path, leaf in want:
        have = got
        for k in path:
            have = have[k.key]
        np.testing.assert_allclose(have, leaf, rtol=0, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))


CASES = {"single": ("single", None), "autoregressive": ("autoregressive", T0 + 6)}
# Adam turns the f32 rounding of a gradient element near zero into a step of
# up to lr, so the packages drift apart in proportion to lr; at the config's
# 1e-3 three steps stay inside the bounds below with a margin of 3x
LR = 1e-3


@pytest.mark.parametrize("training_type, t_train", CASES.values(), ids=CASES.keys())
def test_baseline_step_matches_jax(setup, training_type, t_train):
    """Three production steps: loss and pre-clip grad norm within rtol 1e-5
    each step, the parameters after within 1e-5 of the largest parameter
    magnitude."""
    data, grid, idxs, flax_model, tree = setup
    with precision("highest"):
        tx = jax_make_optimizer(LR, 10)
        jstep, _ = jax_build_step(flax_model, tx, T0, 1, training_type, t_train)
        pj = jax.tree_util.tree_map(jnp.asarray, tree)
        state = tx.init(pj)
        params, step, _ = _port_step(tree, training_type, t_train)
        for k, idx in enumerate(idxs):
            pj, state, loss_j, gn_j = jstep(pj, state, jnp.asarray(data), jnp.asarray(grid),
                                            jnp.asarray(idx), jax.random.PRNGKey(0))
            loss_t, gn_t = step(torch.from_numpy(data), torch.from_numpy(grid),
                                torch.from_numpy(idx).long())
            np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5,
                                       err_msg=f"loss at step {k}")
            np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-5,
                                       err_msg=f"grad norm at step {k}")
    _assert_params_close(params, pj)


@pytest.mark.parametrize("training_type, t_train", CASES.values(), ids=CASES.keys())
def test_val_loss_matches_jax(setup, training_type, t_train):
    data, grid, idxs, flax_model, tree = setup
    with precision("highest"):
        _, jval = jax_build_step(flax_model, jax_make_optimizer(LR, 10), T0, 1,
                                 training_type, t_train)
        _, _, val = _port_step(tree, training_type, t_train)
        for idx in idxs:
            want = float(jval(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(data),
                              jnp.asarray(grid), jnp.asarray(idx)))
            got = val(torch.from_numpy(data), torch.from_numpy(grid), torch.from_numpy(idx).long())
            assert not got.requires_grad
            np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("training_type, t_train", CASES.values(), ids=CASES.keys())
def test_step_scan_equals_single_steps_and_jax(setup, training_type, t_train):
    """step.scan over a (3, B, 2) chunk: exactly what three calls of step
    give, and JAX's step.scan from the same tree and chunk at the
    three-step test's bounds."""
    data, grid, idxs, flax_model, tree = setup
    data_t, grid_t = torch.from_numpy(data), torch.from_numpy(grid)
    chunk = np.stack(idxs)
    with precision("highest"):
        params_a, step_a, _ = _port_step(tree, training_type, t_train)
        single = [step_a(data_t, grid_t, idx) for idx in torch.from_numpy(chunk).long()]
        params_b, step_b, _ = _port_step(tree, training_type, t_train)
        losses, g_norms = step_b.scan(data_t, grid_t, torch.from_numpy(chunk).long())
        tx = jax_make_optimizer(LR, 10)
        jstep, _ = jax_build_step(flax_model, tx, T0, 1, training_type, t_train)
        pj = jax.tree_util.tree_map(jnp.asarray, tree)
        pj, _, losses_j, gns_j = jstep.scan(pj, tx.init(pj), jnp.asarray(data), jnp.asarray(grid),
                                            jnp.asarray(chunk), jax.random.PRNGKey(0))
    assert losses.shape == g_norms.shape == (3,)
    assert torch.equal(losses, torch.stack([l for l, _ in single]))
    assert torch.equal(g_norms, torch.stack([g for _, g in single]))
    for name, p in params_b.items():
        assert torch.equal(p, params_a[name]), name
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    np.testing.assert_allclose(g_norms.numpy(), np.asarray(gns_j), rtol=1e-5)
    _assert_params_close(params_b, pj)


def test_step_xy_equals_step(setup):
    """step.xy on windows gathered beforehand gives what step gives on their
    indices: the same loss, grad norm and parameters."""
    data, grid, idxs, flax_model, tree = setup
    data_t, grid_t = torch.from_numpy(data), torch.from_numpy(grid)
    params_a, step_a, _ = _port_step(tree, "single", None)
    params_b, step_b, _ = _port_step(tree, "single", None)
    for idx in torch.from_numpy(np.stack(idxs)).long():
        x, y = gather_windows(data_t, idx, T0, 1)
        want, got = step_a(data_t, grid_t, idx), step_b.xy(x, y, grid_t)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, p in params_b.items():
        assert torch.equal(p, params_a[name]), name
