"""The optax transforms of the comparison trainers in the port
(``sciml_pde_torch/train/optim.py``): ``AdamW(clip=...)`` against optax
``chain(clip_by_global_norm, adamw(cosine_decay_schedule))`` and ``AMSGrad``
against the point-set BVP's reference recipe ``chain(clip_by_global_norm,
add_decayed_weights, scale_by_amsgrad, scale_by_learning_rate(
warmup_cosine_decay_schedule))``, step for step over 5 steps from the same
parameters and gradients, within 1e-6 of each leaf's largest magnitude.
The gradients cross the clip on some steps and not on others, and one leaf
takes a zero gradient every step (the Fourier features' ``B``, which only
weight decay moves)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_torch.train.optim import (
    AdamW,
    AMSGrad,
    clip_by_global_norm,
    make_lr_schedule,
    warmup_cosine_decay_schedule,
)

SHAPES = {"w": (6, 5), "b": (5,), "B": (2, 4)}


def _steps(seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(5):
        amp = 0.05 if i % 2 else 3.0  # under and over the clip of 1.0 / 2.0
        g = {k: (amp * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        g["B"] = np.zeros(SHAPES["B"], np.float32)
        grads.append(g)
    return params, grads


def _run_both(tx, make_opt):
    params, grads = _steps()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = make_opt(tp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        for k in SHAPES:
            want = np.asarray(jp[k])
            err = np.abs(tp[k].numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-6, (k, err)
    assert not np.allclose(np.asarray(jp["B"]), params["B"])  # decayed


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_with_clip_matches_optax(clip):
    sched = optax.cosine_decay_schedule(3e-2, 7)
    tx = optax.adamw(sched)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    _run_both(tx, lambda tp: AdamW(tp, make_lr_schedule("cosine", 3e-2, 7), clip=clip))


def test_reference_recipe_amsgrad_matches_optax():
    lr, steps = 3e-2, 20
    kw = dict(init_value=lr / 1e2, peak_value=lr, warmup_steps=max(int(0.1 * steps), 1),
              decay_steps=steps, end_value=lr / 1e4)
    tx = optax.chain(optax.clip_by_global_norm(2.0), optax.add_decayed_weights(1e-4),
                     optax.scale_by_amsgrad(),
                     optax.scale_by_learning_rate(optax.warmup_cosine_decay_schedule(**kw)))
    _run_both(tx, lambda tp: AMSGrad(tp, warmup_cosine_decay_schedule(**kw), 1e-4, clip=2.0))


def test_warmup_cosine_and_clip_match_optax():
    kw = dict(init_value=1e-5, peak_value=1e-3, warmup_steps=3, decay_steps=11, end_value=1e-7)
    want = optax.warmup_cosine_decay_schedule(**kw)
    got = warmup_cosine_decay_schedule(**kw)
    np.testing.assert_allclose([got(c) for c in range(14)],
                               [float(want(c)) for c in range(14)], rtol=1e-6,
                               atol=1e-6 * kw["peak_value"])  # optax sums in f32
    with pytest.raises(ValueError, match="positive decay_steps"):
        warmup_cosine_decay_schedule(1.0, 1.0, 2, 2)
    _, grads = _steps()
    for g, c in ((grads[0], 1.0), (grads[1], 1.0), (grads[0], 1e3)):
        jg = optax.clip_by_global_norm(c).update({k: jnp.asarray(v) for k, v in g.items()},
                                                 optax.EmptyState())[0]
        tg, norm = clip_by_global_norm([torch.tensor(g[k]) for k in SHAPES], c)
        for k, t in zip(SHAPES, tg):
            np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg if c == 1e3 else
                                                                           {k: jnp.asarray(v)
                                                                            for k, v in
                                                                            g.items()})),
                                   rtol=1e-6)
