"""Port of the transformer's aux model and step (models/transformer.py
``VideoMAEOperatorAux``, ``use_checkpoint``; train/transformer_train.py
``build_transformer_aux_step``) vs the JAX package, at img 32, patch 8,
tubelet 2, 4 frames: 32 tokens, the fused attention path (JAX's Pallas
kernels in interpret mode, the port's plain versions).  The trainer's aux
runs are in test_torch_transformer_aux_train.py.

Tolerances, relative to the largest magnitude of the JAX result (per
parameter for gradients): f32 1e-5, bf16 3e-2; an updated tree as the
trained runs of test_torch_transformer_train.py::test_one_epoch_matches_jax,
rtol 1e-3 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import transformer as jt
from sciml_pde_tpu.train import transformer_train as jtt
from sciml_pde_torch.models import transformer as tt
from sciml_pde_torch.ops import attention as ta
from sciml_pde_torch.train import transformer_train as ttt
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)

from _torch_parity import assert_trees_close, to_numpy_tree

CFG = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, num_frames=4,
           encoder_dim=32, encoder_depth=2, encoder_heads=2, decoder_dim=16,
           decoder_depth=1, decoder_heads=1)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# the aux stream: the primary's shape, or 16^2 (8 tokens: the trunk runs twice)
AUX_SHAPES = {"equal": (6, 4, 32, 32, 3), "unequal": (6, 4, 16, 16, 3)}
TRAIN_TOL = dict(rtol=1e-3, atol=1e-6)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaf(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", key)]
    return tree


def _assert_tree_rel(got, want, tol, what):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        err = _rel(_leaf(got, path), w)
        assert err <= tol, (what, jax.tree_util.keystr(path), err)


@pytest.fixture(scope="module")
def trees():
    """One flax init of each head variant (layer scale on), f32 parameters."""
    x = jnp.asarray(_x(0, (2, 4, 32, 32, 3)))
    out = {}
    for shared in (False, True):
        model = jt.VideoMAEOperatorAux(**CFG, init_values=0.1, shared_head=shared)
        out[shared] = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(1), x, x)["params"])
    return out


def test_aux_tree_round_trip(trees):
    """The flax aux tree (with head_primary / head_auxiliary) carries across
    the weight conversion unchanged, and the port's module has its names and
    shapes."""
    for shared, tree in trees.items():
        model = tt.VideoMAEOperatorAux(**CFG, init_values=0.1, shared_head=shared)
        model.load_state_dict(transformer_flax_to_state_dict(tree), strict=True)
        back = transformer_state_dict_to_flax(model.state_dict())
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        assert ("head_primary" in tree) is (not shared)
    assert tuple(trees[False]["head_auxiliary"]["kernel"].shape) == (3, 3)


def _aux_inputs(shapes):
    x, xa = _x(2, (2, 4, 32, 32, 3)), 2 * _x(3, AUX_SHAPES[shapes]) + 1
    y, ya = _x(4, (2, 32, 32, 3)), _x(5, AUX_SHAPES[shapes][:1] + AUX_SHAPES[shapes][2:])
    return x, xa, y, ya


_JAX_AUX: dict = {}


def _jax_aux(params, shared, dtype, shapes):
    """JAX's loss, outputs and gradients of lp + 0.7 la (one jit a case,
    kept for the module: the bf16 cases read the f32 ones as their
    control)."""
    key = (shared, dtype, shapes)
    if key not in _JAX_AUX:
        x, xa, y, ya = _aux_inputs(shapes)
        model = jt.VideoMAEOperatorAux(**CFG, init_values=0.1, shared_head=shared,
                                       dtype=DTYPES[dtype][0])

        def loss_j(p):
            pp, pa = model.apply({"params": p}, jnp.asarray(x), jnp.asarray(xa))
            return jtt.transformer_nrmse(pp, y) + 0.7 * jtt.transformer_nrmse(pa, ya), (pp, pa)

        (loss, outs), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
        _JAX_AUX[key] = float(loss), [np.asarray(o) for o in outs], to_numpy_tree(grads)
    return _JAX_AUX[key]


@pytest.mark.parametrize("shapes", AUX_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [False, True], ids=["heads", "shared_head"])
def test_aux_forward_and_grads_match_jax(trees, shared, dtype, shapes):
    """Both outputs and every gradient of lp + 0.7 la.  In bf16 a bias's
    gradient sums bf16 terms over every token, so two packages' roundings
    put it as far apart as JAX's own bf16 result lies from its f32 one:
    each gradient within 3e-2, or within 1.5 times that gap where the gap
    is larger (the f32 result as the control)."""
    _, tdt, tol = DTYPES[dtype]
    x, xa, y, ya = _aux_inputs(shapes)
    params = trees[shared]
    loss_w, outs_w, grads_w = _jax_aux(params, shared, dtype, shapes)
    model = tt.VideoMAEOperatorAux(**CFG, init_values=0.1, shared_head=shared, dtype=tdt)
    model.load_state_dict(transformer_flax_to_state_dict(params))
    pp, pa = model(torch.tensor(x), torch.tensor(xa))
    loss = ttt.transformer_nrmse(pp, torch.tensor(y)) + 0.7 * ttt.transformer_nrmse(
        pa, torch.tensor(ya))
    loss.backward()
    assert pp.dtype == pa.dtype == torch.float32 and tuple(pa.shape) == ya.shape
    for got, want in zip((pp, pa), outs_w):
        assert _rel(got, want) <= tol
    np.testing.assert_allclose(float(loss.detach()), loss_w, rtol=tol)
    grads = transformer_state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})
    ctl = _jax_aux(params, shared, "f32", shapes)[2] if dtype == "bf16" else None
    for path, w in jax.tree_util.tree_leaves_with_path(grads_w):
        lim = tol if ctl is None else max(tol, 1.5 * _rel(_leaf(ctl, path), w))
        err = _rel(_leaf(grads, path), w)
        assert err <= lim, (jax.tree_util.keystr(path), err, lim)
    # the primary stream alone (validation's path) gives the same primary output
    with torch.no_grad():
        assert _rel(model.primary(torch.tensor(x)), outs_w[0]) <= tol


# ---------------------------------------------------------------------------
# one step of build_transformer_aux_step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "pairing p*nA+j": dict(row_map=None, aux_x=32, aux_dtype="f32"),
    "row map": dict(row_map=np.array([[3, 0], [5, 1]], np.int32), aux_x=32, aux_dtype="f32"),
    "aux_resize_to, bf16 aux store": dict(row_map=None, aux_x=16, aux_dtype="bf16"),
}


@pytest.mark.parametrize("case", STEP_CASES)
def test_aux_step_matches_jax(trees, case):
    """One f32 step (grad_accum 1, clip 0.1 active): loss, lp, la and the
    pre-clip grad norm within 1e-5, the updated tree within the trained
    runs' bound."""
    import ml_dtypes

    spec = STEP_CASES[case]
    prim = _x(6, (2, 7, 32, 32, 3))
    aux = 2 * _x(7, (6, 7, spec["aux_x"], spec["aux_x"], 3)) + 0.5
    if spec["aux_dtype"] == "bf16":
        aux = aux.astype(ml_dtypes.bfloat16)
    resize = (32, 32) if spec["aux_x"] != 32 else None
    idx = np.array([[0, 1], [1, 2]], np.int32)
    params = trees[False]
    kw = dict(clip=0.1, warmup_steps=0, grad_accum=1)
    model_j = jt.VideoMAEOperatorAux(**CFG, init_values=0.1)
    tx = jtt.make_transformer_optimizer(1e-3, 2e-3, 10, **kw)
    step_j, _ = jtt.build_transformer_aux_step(model_j, tx, 4, 2, 0.7, spec["row_map"],
                                               aux_resize_to=resize)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    p_j, _, (loss_w, lp_w, la_w), gn_w = step_j(p_j, tx.init(p_j), jnp.asarray(prim),
                                                jnp.asarray(aux), jnp.asarray(idx))

    model = tt.VideoMAEOperatorAux(**CFG, init_values=0.1)
    model.load_state_dict(transformer_flax_to_state_dict(params))
    opt = ttt.make_transformer_optimizer(dict(model.named_parameters()), 1e-3, 2e-3, 10, **kw)
    step, _ = ttt.build_transformer_aux_step(model, opt, 4, 2, 0.7, spec["row_map"],
                                             aux_resize_to=resize)
    aux_t = (torch.tensor(aux.astype(np.float32)).bfloat16() if spec["aux_dtype"] == "bf16"
             else torch.tensor(aux))
    (loss, lp, la), gn = step(torch.tensor(prim), aux_t, torch.tensor(idx, dtype=torch.long))
    for got, want in ((loss, loss_w), (lp, lp_w), (la, la_w), (gn, gn_w)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(gn) > 0.1  # the clip acted
    # Adam's first update divides each gradient by its own size, so where a
    # gradient is near zero it carries the f32 noise up: the trained runs'
    # parameter bound
    assert_trees_close(transformer_state_dict_to_flax(dict(model.named_parameters())),
                       to_numpy_tree(p_j), what="updated tree", **TRAIN_TOL)


# ---------------------------------------------------------------------------
# use_checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_tree():
    model = jt.VideoMAEOperator(**CFG, drop_path_rate=0.2)
    return to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(3),
                                             jnp.zeros((2, 4, 32, 32, 3)))["params"])


def _grads(model, x, y, **kw):
    loss = ttt.transformer_nrmse(model(torch.tensor(x), **kw), torch.tensor(y))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return [loss.detach()] + list(grads)


def test_use_checkpoint_matches_jax_remat(base_tree):
    """use_checkpoint=True against JAX's nn.remat(Block) (f32, 1e-5) and
    against the port without it (the same bits); the recompute runs the
    fused attention again (each block's forward twice)."""
    x, y = _x(8, (2, 4, 32, 32, 3)), _x(9, (2, 32, 32, 3))
    model_j = jt.VideoMAEOperator(**CFG, drop_path_rate=0.2, use_checkpoint=True)

    def loss_j(p):
        return jtt.transformer_nrmse(model_j.apply({"params": p}, jnp.asarray(x)), y)

    loss_w, grads_w = jax.jit(jax.value_and_grad(loss_j))(base_tree)
    outs = {}
    for remat in (False, True):
        calls = []
        real = ta._FlashCore.apply
        ta._FlashCore.apply = lambda *a: calls.append(1) or real(*a)  # noqa: E731
        try:
            model = tt.VideoMAEOperator(**CFG, drop_path_rate=0.2, use_checkpoint=remat)
            model.load_state_dict(transformer_flax_to_state_dict(base_tree))
            outs[remat] = _grads(model, x, y)
        finally:
            ta._FlashCore.apply = real
        assert len(calls) == (6 if remat else 3), len(calls)  # 3 blocks, + the recompute
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(outs[True][0]), float(loss_w), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = transformer_state_dict_to_flax(dict(zip(names, outs[True][1:])))
    _assert_tree_rel(grads, to_numpy_tree(grads_w), 1e-5, "remat gradients")


def test_use_checkpoint_replays_drop_path(base_tree):
    """With deterministic=False and drop-path 0.2 the recompute draws the
    forward's masks again (JAX's remat replays the dropout key): gradients
    equal the run without checkpointing from the same generator, which ends
    in the same state; a generator that draws afresh in the recompute
    gives other gradients (the control)."""
    x, y = _x(10, (4, 4, 32, 32, 3)), _x(11, (4, 32, 32, 3))
    outs, states = {}, {}
    for remat in (False, True):
        model = tt.VideoMAEOperator(**CFG, drop_path_rate=0.2, use_checkpoint=remat)
        model.load_state_dict(transformer_flax_to_state_dict(base_tree))
        gen = torch.Generator().manual_seed(4)
        outs[remat] = _grads(model, x, y, deterministic=False, generator=gen)
        states[remat] = gen.get_state()
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    assert torch.equal(states[True], states[False])
    # control: a checkpoint that lets the generator draw again in the recompute
    model = tt.VideoMAEOperator(**CFG, drop_path_rate=0.2)
    model.load_state_dict(transformer_flax_to_state_dict(base_tree))
    gen = torch.Generator().manual_seed(4)
    blocks = [getattr(model.encoder, f"block{i}") for i in range(2)] + [model.decoder.block0]
    for blk in blocks:
        blk.forward = (lambda b: lambda x, d, g: torch.utils.checkpoint.checkpoint(
            type(b).forward, b, x, d, g, use_reentrant=False))(blk)
    ctl = _grads(model, x, y, deterministic=False, generator=gen)
    assert not all(torch.equal(a, b) for a, b in zip(ctl[1:], outs[False][1:]))
