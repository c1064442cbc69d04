"""Port models/transformer.py vs the JAX package: patchify / unpatchify, the
position table, the weight conversion, and the VideoMAEOperator forward and
every parameter gradient of the nRMSE^2 loss from converted weights.

Tolerances, relative to the largest magnitude of the JAX result (per
parameter for gradients): f32 1e-4 (sums in another order); bf16 3e-2
(roundings to bf16 at other points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import transformer as jt
from sciml_pde_tpu.train.transformer_train import transformer_nrmse as jax_nrmse
from sciml_pde_torch.models import transformer as tt
from sciml_pde_torch.train.transformer_train import transformer_nrmse
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)

from _torch_parity import to_numpy_tree

# img 32, patch 8, tubelet 2, 4 frames -> 32 tokens (the fused attention
# path); dims 32 / 16, depth 2 / 1
CFG = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, num_frames=4,
           encoder_dim=32, encoder_depth=2, encoder_heads=2, decoder_dim=16,
           decoder_depth=1, decoder_heads=1)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _x(seed=0, shape=(2, 4, 32, 32, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """One flax init (with layer scale) for every test: parameters are f32
    whatever the compute dtype."""
    init = jax.jit(jt.VideoMAEOperator(**CFG, init_values=0.1).init)
    return to_numpy_tree(init(jax.random.PRNGKey(1), jnp.asarray(_x()))["params"])


def test_patchify_unpatchify_match_jax():
    x = _x(1, (2, 4, 16, 24, 3))
    want = np.asarray(jt.patchify(jnp.asarray(x), 2, 8))
    got = tt.patchify(torch.tensor(x), 2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tt.unpatchify(got, 2, 8, 4, 16, 24, 3)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jt.unpatchify(jnp.asarray(want), 2, 8, 4, 16, 24, 3)))


def test_sinusoid_table_matches_jax():
    np.testing.assert_array_equal(tt.sinusoid_table(40, 24), jt.sinusoid_table(40, 24))


def test_weight_round_trip(params):
    model = tt.VideoMAEOperator(**CFG, init_values=0.1)
    sd = transformer_flax_to_state_dict(params)
    model.load_state_dict(sd, strict=True)  # every name and shape is the flax one
    assert tuple(sd["encoder.block0.attn.qkv_kernel"].shape) == (32, 96)
    back = transformer_state_dict_to_flax(model.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_seeded_init_has_flax_shapes_and_initialisers(params):
    sd = tt.VideoMAEOperator(**CFG, init_values=0.1,
                             generator=torch.Generator().manual_seed(0)).state_dict()
    flat = transformer_flax_to_state_dict(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                         for k, v in flat.items()}
    k = sd["encoder.block0.mlp.fc1.kernel"]
    assert k.abs().max() <= (6 / (32 + 128)) ** 0.5 and k.std() > 0.05
    assert torch.all(sd["encoder.block0.attn.q_bias"] == 0)
    assert torch.all(sd["decoder_norm.scale"] == 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_grads_match_jax(params, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, tgt = _x(2), _x(3, (2, 32, 32, 3))
    model_j = jt.VideoMAEOperator(**CFG, init_values=0.1, dtype=jdt)

    def loss_j(p):
        pred = model_j.apply({"params": p}, jnp.asarray(x))
        return jax_nrmse(pred, jnp.asarray(tgt)), pred

    (loss_want, pred_want), grads_want = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    model = tt.VideoMAEOperator(**CFG, init_values=0.1, dtype=tdt)
    model.load_state_dict(transformer_flax_to_state_dict(params))
    pred = model(torch.tensor(x))
    loss = transformer_nrmse(pred, torch.tensor(tgt))
    loss.backward()
    assert pred.dtype == torch.float32 and tuple(pred.shape) == (2, 32, 32, 3)
    want = np.asarray(pred_want)
    err = np.abs(pred.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), rtol=tol)
    grads = transformer_state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})
    for path, w in jax.tree_util.tree_leaves_with_path(to_numpy_tree(grads_want)):
        g = grads
        for key in path:
            g = g[key.key]
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)


def test_attention_impls_agree_in_f32():
    """flash (here the plain versions), plain and jnp attention are one
    function in f32."""
    x = torch.tensor(_x(4, (2, 32, 32)))
    outs = []
    for impl in ("flash", "plain", "jnp"):
        att = tt.Attention(32, 2, attn_impl=impl, generator=torch.Generator().manual_seed(0))
        outs.append(att(x).detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=1e-5, atol=1e-6)


def test_drop_path():
    x = torch.ones(1000, 3)
    assert tt.drop_path(x, 0.25, True, None) is x
    y = tt.drop_path(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y[:, 0] != 0
    assert torch.all(y[kept] == 1 / 0.75) and torch.all(y[~kept] == 0)
    assert abs(kept.float().mean().item() - 0.75) < 0.05


def test_unported_branches_raise():
    """The branches that raised before they were ported (``use_checkpoint``,
    ``ssl`` and its ``mask`` path) now run: remat gives the plain model's
    output, the masked path returns the masked tokens' pixels, and a mask on
    a model without ``ssl`` raises ValueError."""
    x = torch.tensor(_x())
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    plain = tt.VideoMAEOperator(**CFG, generator=gen())
    remat = tt.VideoMAEOperator(**CFG, use_checkpoint=True, generator=gen())
    torch.testing.assert_close(remat(x), plain(x), rtol=0, atol=0)
    ssl = tt.VideoMAEOperator(**CFG, ssl=True, generator=gen())
    mask = torch.zeros(2, 32, dtype=torch.bool)
    mask[:, ::4] = True
    out = ssl(x, mask=mask)
    assert tuple(out.shape) == (2, 8, 2 * 8 * 8 * 3) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="ssl=True"):
        plain(x, mask=mask)
