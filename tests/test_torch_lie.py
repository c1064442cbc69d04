"""Port of sim/lie.py (Lie-point-symmetry augmentation of NS windows) vs the
JAX package's: each of the nine groups, the Lie-Trotter compositions at
orders 2 and 4, ``augment_ns_window`` for given strengths, the draws, and one
``lie_augment`` production step with both samplers patched to one vector
(torch cannot replay JAX's PRNG stream, so parity holds the transform for
the same strengths).  Tolerances: f32 1e-5 of the largest magnitude; the
training step's losses and tree 1e-4, as in test_torch_aux.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.sim import lie as jlie
from sciml_pde_tpu.train import optim as joptim
from sciml_pde_tpu.train.fno_train import build_baseline_step as jax_build_baseline_step
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.sim import lie
from sciml_pde_torch.train import optim
from sciml_pde_torch.train.fno_train import build_baseline_step
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import precision, to_numpy_tree

B, X, Y, T = 3, 6, 5, 4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def state():
    """A seeded (t, x, y, u, v) state of shape (B, X, Y, T) and one strength
    vector a window, drawn past DEFAULT_STRENGTHS' bounds to stress the
    groups."""
    rng = np.random.default_rng(0)
    s = tuple(rng.normal(size=(B, X, Y, T)).astype(np.float32) for _ in range(5))
    g = (rng.uniform(-1, 1, size=(B, 9)) * np.array(jlie.DEFAULT_STRENGTHS) * 3).astype(
        np.float32)
    return s, g


def _jax_per_window(fn, s, g):
    """JAX's scalar-strength function window by window, stacked."""
    outs = [fn(tuple(jnp.asarray(a[b]) for a in s), jnp.asarray(g[b])) for b in range(B)]
    return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(5))


def _port(fn, s, g):
    gt = torch.from_numpy(g).T[:, :, None, None, None]
    return tuple(a.numpy() for a in fn(tuple(map(torch.from_numpy, s)), gt))


@pytest.mark.parametrize("i", range(9), ids=[f"g{i + 1}" for i in range(9)])
def test_each_group_matches_jax(state, i):
    s, g = state
    want = _jax_per_window(lambda st, gg: jlie.NS_GROUPS[i](gg[i], st), s, g)
    got = _port(lambda st, gg: lie.NS_GROUPS[i](gg[i], st), s, g)
    for w, o in zip(want, got):
        assert _rel(o, w) <= 1e-6


@pytest.mark.parametrize("order, steps", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_lie_trotter_exp_matches_jax(state, order, steps):
    s, g = state
    want = _jax_per_window(lambda st, gg: jlie.lie_trotter_exp(st, gg, order=order,
                                                               steps=steps), s, g)
    got = _port(lambda st, gg: lie.lie_trotter_exp(st, gg, order=order, steps=steps), s, g)
    for w, o in zip(want, got):
        assert _rel(o, w) <= 1e-5


def test_augment_ns_window_matches_jax(monkeypatch, state):
    """Three windows (u, v, particles), each with its own strengths: JAX's
    single-window function with its sampler patched to that window's row,
    against the port's batched call."""
    _, g = state
    rng = np.random.default_rng(1)
    win = rng.normal(size=(B, 16, 12, 11, 3)).astype(np.float32)
    want = []
    for b in range(B):
        monkeypatch.setattr(jlie, "sample_strengths", lambda key, _b=b: jnp.asarray(g[_b]))
        want.append(np.asarray(jlie.augment_ns_window(jnp.asarray(win[b]),
                                                      jax.random.PRNGKey(0))))
    got = lie.augment_ns_window(torch.from_numpy(win), torch.from_numpy(g)).numpy()
    assert _rel(got, np.stack(want)) <= 1e-5
    np.testing.assert_array_equal(got[..., 2], win[..., 2])  # particles pass through


def test_zero_strengths_are_the_identity():
    win = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8, 8, 5, 3))
                           .astype(np.float32))
    assert torch.equal(lie.augment_ns_window(win, torch.zeros(2, 9)), win)


def test_draws_are_seeded_and_bounded():
    draw = lambda seed: lie.sample_strengths(torch.Generator().manual_seed(seed), 4000)  # noqa: E731
    a, b, c = draw(5), draw(5), draw(6)
    assert a.shape == (4000, 9) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    s = torch.tensor(lie.DEFAULT_STRENGTHS)
    assert float(a[:, 0].min()) >= 0 and bool((a[:, 0] <= s[0]).all())
    assert bool((a[:, 1:].abs() <= s[1:]).all())
    # each axis spans its interval: the extremes come within 2% of the bounds
    assert bool((a[:, 1:].min(0).values < -0.98 * s[1:]).all())
    assert bool((a.max(0).values > 0.98 * s).all())
    assert lie.DEFAULT_STRENGTHS == jlie.DEFAULT_STRENGTHS


def test_lie_augment_step_matches_jax(monkeypatch):
    """Three production steps with lie_augment on an NS-shaped store (3
    channels), both samplers patched to one strength vector: loss and grad
    norm each step, then the tree."""
    rng = np.random.default_rng(3)
    t0, c, n = 4, 3, 16
    data = rng.normal(size=(3, 9, n, n, c)).astype(np.float32)
    grid = rng.uniform(size=(n, n, 2)).astype(np.float32)
    vec = (rng.uniform(-1, 1, size=9) * np.array(jlie.DEFAULT_STRENGTHS)).astype(np.float32)
    monkeypatch.setattr(jlie, "sample_strengths", lambda key: jnp.asarray(vec))
    monkeypatch.setattr(lie, "sample_strengths",
                        lambda gen, batch, device=None: torch.from_numpy(vec).expand(batch, 9))
    flax_model = FlaxFNO2d(num_channels=c, modes1=4, modes2=4, width=8, initial_step=t0)
    params = to_numpy_tree(jax.jit(flax_model.init)(jax.random.PRNGKey(4),
                                                    jnp.zeros((1, n, n, t0, c)),
                                                    jnp.zeros((1, n, n, 2)))["params"])
    batches = [np.array([[0, 1], [2, 3]]), np.array([[1, 4], [0, 0]]), np.array([[2, 2], [1, 5]])]
    with precision("highest"):
        tx = joptim.make_optimizer(2e-3, 3)
        jstep, _ = jax_build_baseline_step(flax_model, tx, t0, 1, lie_augment=True)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jst = tx.init(jp)
        model = FNO2d(c, 4, 4, 8, t0)
        model.load_state_dict(flax_to_state_dict(params))
        opt = optim.make_optimizer(dict(model.named_parameters()), 2e-3, 3)
        step, _ = build_baseline_step(model, opt, t0, 1, lie_augment=True)
        for idx in batches:
            jp, jst, jl, jg = jstep(jp, jst, jnp.asarray(data), jnp.asarray(grid),
                                    jnp.asarray(idx, jnp.int32), jax.random.PRNGKey(0))
            tl, tg = step(torch.from_numpy(data), torch.from_numpy(grid),
                          torch.from_numpy(idx).long())
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
            np.testing.assert_allclose(float(tg), float(jg), rtol=1e-4)
    want = to_numpy_tree(jp)
    got = state_dict_to_flax(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        assert _rel(have, leaf) <= 1e-4, jax.tree_util.keystr(path)
