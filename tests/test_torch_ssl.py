"""Port of the masked-SSL path vs the JAX package: the masked branch of
``VideoMAEOperator`` for a given mask, ``make_tube_mask``'s fixed count, the
SSL loss and its gradients, optax ``adamw``, ``load_partial_params``, and
``run_ssl_pretraining`` into the trainer's ``pretrained_path``.  img 32,
patch 8, tubelet 2, 4 frames: 32 tokens, 8 visible at mask ratio 0.75 (both
counts take the fused attention path).

Tolerances, relative to the largest magnitude of the JAX result: f32 1e-5,
bf16 3e-2; the optimizer (synthetic gradients) rtol 1e-5 as in
test_torch_transformer_train.py::test_optimizer_matches_optax."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_tpu.models import transformer as jt
from sciml_pde_tpu.models.common import instance_norm_stats as jax_instance_norm_stats
from sciml_pde_tpu.utils.checkpoint import load_partial_params as jax_load_partial_params
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.models import transformer as tt
from sciml_pde_torch.train import optim
from sciml_pde_torch.train import ssl_pretrain as ssl
from sciml_pde_torch.train.transformer_train import run_transformer_training
from sciml_pde_torch.utils.checkpoint import (
    load_partial_params,
    partial_load_counts,
    restore_checkpoint,
)
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)

from _torch_parity import to_numpy_tree

CFG = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, num_frames=4,
           encoder_dim=32, encoder_depth=2, encoder_heads=2, decoder_dim=16,
           decoder_depth=1, decoder_heads=1)
N_TOKENS, N_MASKED = 32, 24
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _x(seed, shape=(2, 4, 32, 32, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(seed, b=2):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, N_TOKENS), bool)
    for r in range(b):
        mask[r, rng.permutation(N_TOKENS)[:N_MASKED]] = True
    return mask


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _port_ssl(tree, **kw):
    """The port's SSL model on a flax SSL tree (which has no ``head``)."""
    model = tt.VideoMAEOperator(**CFG, ssl=True, **kw)
    sd = model.state_dict()
    sd.update(transformer_flax_to_state_dict(tree))
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def ssl_tree():
    model = jt.VideoMAEOperator(**CFG, ssl=True)
    init = jax.jit(model.init, static_argnums=(3, 4))
    return to_numpy_tree(init(jax.random.PRNGKey(2), jnp.asarray(_x(0)),
                              jnp.asarray(_mask(0)), True, N_MASKED)["params"])


def test_ssl_tree_names(ssl_tree):
    """The SSL init holds head_ssl and a (1, 1, decoder) mask token and no
    head; the port's seeded mask token is truncated-normal with std 0.02."""
    assert "head" not in ssl_tree and tuple(ssl_tree["mask_token"].shape) == (1, 1, 16)
    assert set(ssl.ssl_parameters(tt.VideoMAEOperator(**CFG, ssl=True))) == set(
        transformer_flax_to_state_dict(ssl_tree))
    token = tt.VideoMAEOperator(**dict(CFG, decoder_dim=4096), ssl=True,
                                generator=torch.Generator().manual_seed(0)).mask_token
    assert abs(token.std().item() - 0.02) < 1e-3 and token.abs().max() <= 2 * 0.02 / 0.8796


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_forward_matches_jax(ssl_tree, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, mask = _x(1), _mask(1)
    want = jax.jit(jt.VideoMAEOperator(**CFG, ssl=True, dtype=jdt).apply,
                   static_argnums=(3, 4))({"params": ssl_tree}, jnp.asarray(x),
                                          jnp.asarray(mask), True, N_MASKED)
    model = _port_ssl(ssl_tree, dtype=tdt)
    got = model(torch.tensor(x), torch.tensor(mask), n_masked=N_MASKED)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, N_MASKED, 2 * 8 * 8 * 3)
    assert _rel(got, want) <= tol
    # the count from the mask itself, as JAX takes it from a concrete mask
    again = model(torch.tensor(x), torch.tensor(mask))
    assert torch.equal(again, got)


def test_tube_mask_has_a_fixed_count():
    gen = torch.Generator().manual_seed(3)
    for ratio, n in ((0.75, 24), (0.5, 16), (0.9, 29)):
        mask = ssl.make_tube_mask(gen, 5, N_TOKENS, ratio)
        assert mask.dtype == torch.bool and tuple(mask.shape) == (5, N_TOKENS)
        assert mask.sum(dim=1).tolist() == [n] * 5
    a = ssl.make_tube_mask(torch.Generator().manual_seed(1), 4, N_TOKENS, 0.75)
    b = ssl.make_tube_mask(torch.Generator().manual_seed(1), 4, N_TOKENS, 0.75)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])


def test_ssl_loss_and_grads_match_jax(ssl_tree):
    """The SSL loss (masked-pixel MSE in normalised space) and every
    gradient, f32, against JAX's loss on the same mask."""
    x, mask = _x(2), _mask(2)
    model_j = jt.VideoMAEOperator(**CFG, ssl=True)

    def loss_j(p):
        pred = model_j.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask), True, N_MASKED)
        std, mean = jax_instance_norm_stats(jnp.asarray(x), (1, 2, 3))
        tokens = jt.patchify((jnp.asarray(x) - mean) / std, 2, 8)
        idx = jnp.argsort(jnp.asarray(mask), axis=1, stable=True)[:, N_TOKENS - N_MASKED:]
        target = jnp.take_along_axis(tokens, idx[..., None], axis=1)
        return jnp.mean((pred - target) ** 2)

    loss_w, grads_w = jax.jit(jax.value_and_grad(loss_j))(ssl_tree)
    model = _port_ssl(ssl_tree)
    params = ssl.ssl_parameters(model)
    loss = ssl.ssl_loss(model, torch.tensor(x), torch.tensor(mask), N_MASKED)
    grads = transformer_state_dict_to_flax(
        dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), rtol=1e-5)
    for path, w in jax.tree_util.tree_leaves_with_path(to_numpy_tree(grads_w)):
        g = grads
        for key in path:
            g = g[key.key]
        assert _rel(g, w) <= 1e-5, (jax.tree_util.keystr(path), _rel(g, w))


def test_adamw_matches_optax():
    """optax.adamw(cosine_decay_schedule(lr, total)) with its defaults
    (weight decay 1e-4 on every leaf) over six steps of synthetic
    gradients, through the end of the decay."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": 3 * rng.normal(size=(5,)).astype(np.float32)}
    tx = optax.adamw(optax.cosine_decay_schedule(1e-2, 4))
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(p_j)
    p_t = {k: torch.tensor(v) for k, v in tree.items()}
    opt = optim.AdamW(p_t, optim.make_lr_schedule("cosine", 1e-2, 4), weight_decay=1e-4)
    for _ in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in tree.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        opt.step(p_t, {k: torch.tensor(v) for k, v in g.items()})
        for k in tree:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-5, atol=1e-7)
    assert opt.count == 6


def test_load_partial_params_matches_jax(capsys):
    """A leaf the pretrained tree lacks and one whose shape differs stay
    fresh; every other leaf comes from the pretrained tree, and a leaf only
    the pretrained tree has is ignored, as in JAX."""
    rng = np.random.default_rng(5)
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    fresh = {"encoder": {"w": r(3, 4), "b": r(4)}, "head": {"kernel": r(4, 2)},
             "head_primary": {"kernel": r(3, 3)}}
    pre = {"encoder": {"w": r(3, 4), "b": r(5)}, "head": {"kernel": r(4, 2)},
           "head_ssl": {"kernel": r(4, 6)}}
    want = jax_load_partial_params(fresh, pre)
    jax_line = capsys.readouterr().out
    got = load_partial_params({k: {n: torch.tensor(v) for n, v in d.items()}
                               for k, d in fresh.items()},
                              {k: {n: torch.tensor(v) for n, v in d.items()}
                               for k, d in pre.items()})
    assert capsys.readouterr().out == jax_line == "load_partial_params: 2 loaded, 2 kept fresh\n"
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert partial_load_counts(fresh, pre) == (2, 2)


def test_ssl_pretraining_feeds_pretrained_path(tmp_path):
    """run_ssl_pretraining (batch 2, 2 epochs) gives finite losses and a
    checkpoint of the SSL tree (no head); run_transformer_training overlays
    it through pretrained_path: every leaf of the operator it shares with
    the SSL tree comes from the checkpoint, head stays as initialised."""
    rng = np.random.default_rng(6)
    data = rng.normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    train_w = WindowedTrajectories(data, np.zeros((32, 32, 2), np.float32), initial_step=4,
                                   rollout=0, train=True, device="cpu")
    model_kwargs = {k: v for k, v in CFG.items() if k != "num_frames"}
    tree, hist = ssl.run_ssl_pretraining(
        train_w, model_kwargs=dict(model_kwargs, num_frames=4), initial_step=4, batch_size=2,
        epochs=2, learning_rate=1e-3, run_dir=str(tmp_path), model_name="ssl", seed=3,
        log_every=0, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["ssl_loss"]) for h in hist)
    ck = restore_checkpoint(tmp_path / "ssl_ckpt")
    assert "head" not in ck["params"] and "mask_token" in ck["params"]
    assert ck["opt_state"][0]["count"] == 2 * 5  # optax adamw; 10 windows of 4 + 0 frames, batch 2

    for i in (0, 250):
        with h5py.File(tmp_path / f"ns_incom_inhom_2d_256-{i}.h5", "w") as f:
            f["velocity"] = rng.normal(size=(2, 8, 32, 32, 2)).astype(np.float32)
            f["particles"] = rng.uniform(size=(2, 8, 32, 32, 1)).astype(np.float32)
    init = transformer_state_dict_to_flax(
        tt.VideoMAEOperator(**CFG, generator=torch.Generator().manual_seed(9)).state_dict())
    res = run_transformer_training(
        base_path=str(tmp_path), dataset_family="ns", if_aux=False, train_subsample=(1, 1, 1),
        test_range=(250, 251), img_size=32, patch_size=8, tubelet_size=2, in_chans=3,
        encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=16,
        decoder_depth=1, decoder_num_heads=1, initial_step=4, batch_size=2, epochs=0,
        bf16=False, log_every=0, run_dir=str(tmp_path / "op"), model_name="op",
        pretrained_path=str(tmp_path / "ssl_ckpt"), init_params=init, device="cpu")
    flat_res = transformer_flax_to_state_dict(res.params)
    flat_ssl = transformer_flax_to_state_dict(ck["params"])
    shared = [n for n in flat_res if n in flat_ssl]
    assert len(shared) == len(flat_res) - 2  # all but head.kernel and head.bias
    for n in shared:
        assert torch.equal(flat_res[n], flat_ssl[n]), n
    for n in ("head.kernel", "head.bias"):
        assert torch.equal(flat_res[n], transformer_flax_to_state_dict(init)[n])
