"""Port of models/transformer3d.py and ``run_training(model_family=
"transformer3d")`` vs the JAX package: the edge pad, ``patchify3d`` /
``unpatchify3d``, ``VideoMAEOperator3D`` and ``Transformer3DAux`` forward and
gradients, one epoch of the baseline and of aux joint training (nA 3) on a
tiny plume store, and the attention route at the plume shape.

Tiny shape: (8, 8, 11) with patch (4, 4, 4) (Z padded to 12) and tubelet 2
at 4 frames: 24 tokens, the fused attention path.  Tolerances relative to
the largest magnitude of the JAX result: f32 1e-5, bf16 3e-2; trained runs
as in test_torch_transformer_train.py: losses rtol 1e-4, parameters rtol
1e-3 / atol 1e-6."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import transformer3d as j3
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.models import transformer3d as t3
from sciml_pde_torch.ops import attention as ta
from sciml_pde_torch.train.fno_train import run_training, transformer3d_core_kwargs
from sciml_pde_torch.utils.checkpoint import restore_checkpoint
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)

from _torch_parity import assert_trees_close, to_numpy_tree

SP, C, T0, NT = (8, 8, 11), 4, 4, 7
TK = dict(patch_size=(4, 4, 4), tubelet_size=2, encoder_dim=16, encoder_depth=1,
          encoder_heads=2, decoder_dim=16, decoder_depth=1, decoder_heads=2)
CORE = transformer3d_core_kwargs(TK, SP, C, T0)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _assert_grads(model, grads_w, tol, ctl=None):
    """Each gradient of ``model`` within ``tol`` of JAX's, or with a control
    tree (JAX's f32 gradients) within 1.5 times JAX's own gap to it."""
    grads = transformer_state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})
    for path, w in jax.tree_util.tree_leaves_with_path(to_numpy_tree(grads_w)):
        lim = tol if ctl is None else max(tol, 1.5 * _rel(_leaf(ctl, path), w))
        err = _rel(_leaf(grads, path), w)
        assert err <= lim, (jax.tree_util.keystr(path), err, lim)


def test_pad_patchify_unpatchify_match_jax():
    x = _x(0, (2, 4, *SP, C))
    pad_w, pads_w = j3._pad_to_multiple(jnp.asarray(x), (4, 4, 4))
    pad_t, pads_t = t3._pad_to_multiple(torch.tensor(x), (4, 4, 4))
    assert pads_t == tuple(pads_w) == (0, 0, 1)
    np.testing.assert_array_equal(pad_t.numpy(), np.asarray(pad_w))
    want = np.asarray(j3.patchify3d(pad_w, 2, (4, 4, 4)))
    got = t3.patchify3d(pad_t, 2, (4, 4, 4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (2, 24, 2 * 64 * C)
    back = t3.unpatchify3d(got, 2, (4, 4, 4), 4, 8, 8, 12, C)
    np.testing.assert_array_equal(back.numpy(), pad_t.numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j3.unpatchify3d(jnp.asarray(want), 2, (4, 4, 4), 4, 8, 8, 12,
                                                 C)))
    # edge padding repeats the last plane
    np.testing.assert_array_equal(pad_t[..., 11, :].numpy(), x[..., 10, :])


@pytest.fixture(scope="module")
def core_tree():
    model = j3.VideoMAEOperator3D(**CORE, init_values=0.1)
    return to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(1),
                                             jnp.zeros((2, T0, *SP, C)))["params"])


_JAX_CORE: dict = {}


def _jax_core(tree, dtype, x, y):
    """JAX's loss, prediction and gradients (one jit a dtype, kept for the
    module: the bf16 case reads the f32 one as its control)."""
    if dtype not in _JAX_CORE:
        model = j3.VideoMAEOperator3D(**CORE, init_values=0.1, dtype=DTYPES[dtype][0])

        def loss_j(p):
            pred = model.apply({"params": p}, jnp.asarray(x))
            return jnp.mean((pred - y) ** 2), pred

        (loss, pred), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(tree)
        _JAX_CORE[dtype] = float(loss), np.asarray(pred), to_numpy_tree(grads)
    return _JAX_CORE[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_core_forward_and_grads_match_jax(core_tree, dtype):
    """The prediction, the loss and every gradient; in bf16 each gradient
    within 3e-2, or within 1.5 times JAX's own bf16-vs-f32 gap where that is
    larger (as in test_torch_transformer_aux.py)."""
    _, tdt, tol = DTYPES[dtype]
    x, y = 2 * _x(2, (2, T0, *SP, C)) + 1, _x(3, (2, *SP, C))
    loss_w, pred_w, grads_w = _jax_core(core_tree, dtype, x, y)
    model = t3.VideoMAEOperator3D(**CORE, init_values=0.1, dtype=tdt)
    model.load_state_dict(transformer_flax_to_state_dict(core_tree))
    pred = model(torch.tensor(x))
    loss = torch.mean((pred - torch.tensor(y)) ** 2)
    loss.backward()
    assert pred.dtype == torch.float32 and tuple(pred.shape) == (2, *SP, C)
    assert _rel(pred, pred_w) <= tol
    np.testing.assert_allclose(float(loss.detach()), loss_w, rtol=tol)
    ctl = _jax_core(core_tree, "f32", x, y)[2] if dtype == "bf16" else None
    _assert_grads(model, grads_w, tol, ctl)


def test_aux_wrapper_matches_jax():
    """Transformer3DAux on FNO-layout windows (B, X, Y, Z, T, C): both
    outputs (B, X, Y, Z, 1, C) and every gradient, f32."""
    x, xa = _x(4, (1, *SP, T0, C)), 3 * _x(5, (3, *SP, T0, C))
    g = jnp.zeros((1, *SP, 3))
    model_j = j3.Transformer3DAux(core_kwargs=CORE)
    tree = to_numpy_tree(jax.jit(model_j.init)(jax.random.PRNGKey(2), x, g, xa, g)["params"])

    def loss_j(p):
        op, oa = model_j.apply({"params": p}, jnp.asarray(x), g, jnp.asarray(xa), g)
        return jnp.mean(op ** 2) + 0.7 * jnp.mean(oa ** 2), (op, oa)

    (loss_w, outs_w), grads_w = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(tree)
    model = t3.Transformer3DAux(**CORE)
    model.load_state_dict(transformer_flax_to_state_dict(tree), strict=True)
    op, oa = model(torch.tensor(x), None, torch.tensor(xa), None)
    (torch.mean(op ** 2) + 0.7 * torch.mean(oa ** 2)).backward()
    assert tuple(oa.shape) == (3, *SP, 1, C)
    for got, want in zip((op, oa), outs_w):
        assert _rel(got, want) <= 1e-5
    _assert_grads(model, grads_w, 1e-5)


# ---- run_training ---------------------------------------------------------------

def _write_pair(folder, seed, suffix, rng):
    with h5py.File(folder / f"v_trj_seed{seed}{suffix}.h5", "w") as f:
        f["data"] = rng.normal(size=(*SP, NT, 3)).astype(np.float32)
    with h5py.File(folder / f"s_trj_seed{seed}{suffix}.h5", "w") as f:
        f["data"] = rng.uniform(size=(NT, *SP)).astype(np.float32)


@pytest.fixture(scope="module")
def plume(tmp_path_factory):
    """Primary ``_interp`` seeds 0-1 and test seed 5; aux seeds 0-5."""
    d = tmp_path_factory.mktemp("plume_vmae")
    rng = np.random.default_rng(7)
    for s in (0, 1, 5):
        _write_pair(d, s, "_interp", rng)
    for s in range(6):
        _write_pair(d, s, "", rng)
    return d


COMMON = dict(dataset_family="ns3d", model_family="transformer3d", transformer_kwargs=TK,
              train_subsample=(2, 2, 6), test_range=(5, 6), num_aux_samples=3,
              initial_step=T0, num_channels=C, batch_size=2, epochs=1, learning_rate=2e-4,
              learning_rate_share=2e-4, learning_rate_fc2=1e-4, log_every=0, seed=3)


@pytest.mark.parametrize("aux", [False, True], ids=["baseline", "aux"])
def test_run_training_transformer3d_matches_jax(plume, tmp_path, aux):
    """One epoch (three steps of batch 2; aux with 6 aux windows a step)
    from JAX's init, through the FNO trainer's production or aux step, and
    the checkpoint's tree under vit_core.  The production optimizer adds
    1e-4 * p to each gradient before Adam; where that cancels the gradient
    (one patch_proj element of the aux run: 8.3e-6 against -8.3e-6) Adam
    scales f32 noise up to a step of the learning rate's size, so the rate
    is kept at 2e-4 for the parameters' bound to hold that element."""
    core = dict(CORE)
    model_j = j3.Transformer3DAux(core_kwargs=core) if aux else j3.Transformer3DBaseline(
        core_kwargs=core)
    x0, g0 = jnp.zeros((1, *SP, T0, C)), jnp.zeros((1, *SP, 3))
    args = (x0, g0, x0, g0) if aux else (x0, g0)
    init = to_numpy_tree(jax.jit(model_j.init)(jax.random.PRNGKey(3), *args)["params"])
    kw = dict(COMMON, base_path=str(plume), if_aux=aux, model_name="VMAE3D")
    want = jax_run_training(run_dir=str(tmp_path / "j"), **kw)
    got = run_training(run_dir=str(tmp_path / "t"), init_params=init, device="cpu", **kw)
    assert len(got.history) == len(want.history) == 1
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[0][key], want.history[0][key], rtol=1e-4)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=1e-3, atol=1e-6,
                       what="trained 3D VideoMAE")
    moved = np.abs(got.params["vit_core"]["head"]["kernel"] - init["vit_core"]["head"]["kernel"])
    assert moved.max() > 1e-4, moved.max()
    ck = restore_checkpoint(tmp_path / "t" / "VMAE3D_ckpt")
    assert tuple(ck["params"]["vit_core"]["patch_proj"]["kernel"].shape) == (2 * 64 * C, 16)


def test_transformer3d_needs_a_3d_store(tmp_path):
    with pytest.raises(ValueError, match="ns3d"):
        run_training(base_path=str(tmp_path), model_family="transformer3d", device="cpu")
    with pytest.raises(ValueError, match="transformer_kwargs"):
        run_training(base_path=str(tmp_path), transformer_kwargs=TK, device="cpu")


def test_plume_shape_takes_jnp_attention(monkeypatch):
    """At the plume shape (50, 50, 89), patch (10, 10, 9), tubelet 5 and 10
    frames the tokens number 500, which JAX's shape rule sends to
    jnp_attention (500 % 8 != 0): no fused attention runs, in the port too."""
    fused = []
    real = ta._FlashCore.apply
    monkeypatch.setattr(ta._FlashCore, "apply", lambda *a: fused.append(1) or real(*a))
    core = transformer3d_core_kwargs(dict(encoder_dim=16, encoder_depth=1, encoder_heads=2,
                                          decoder_dim=16, decoder_depth=1, decoder_heads=2),
                                     (50, 50, 89), 4, 10)
    model = t3.VideoMAEOperator3D(**core, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(_x(6, (1, 10, 50, 50, 89, 4)))
    tokens = t3.patchify3d(t3._pad_to_multiple(x, core["patch_size"])[0], 5, core["patch_size"])
    assert tokens.shape[1] == 500
    with torch.no_grad():
        out = model(x)
    assert tuple(out.shape) == (1, 50, 50, 89, 4) and bool(torch.isfinite(out).all())
    assert not fused
