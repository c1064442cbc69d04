"""Port of the 3D FNO family vs the JAX package's: ``spectral_conv_3d`` in
its three forms, ``FNO3d`` and ``FNO3dAux`` from one flax tree (values and
gradients), ``remat`` in 2D and 3D, the 3D tree conversion, the plume loader
``load_ns3d_aux`` on tiny HDF5 files in the JAX schema, and
``run_training(dataset_family="ns3d")`` (baseline and aux, two epochs) with
its evaluation.

Tolerances: f32 1e-5 of the largest magnitude (model outputs, the spectral
conv); gradients 1e-4 of each leaf's largest magnitude; training histories
1e-4 relative and trained trees 1e-4 of each leaf's largest magnitude, as
in test_torch_aux.py."""

import pickle

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import ns3d as jns3d
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.models import FNO3d as FlaxFNO3d
from sciml_pde_tpu.models import FNO3dAux as FlaxFNO3dAux
from sciml_pde_tpu.ops.spectral import spectral_conv_3d as jax_spectral_conv_3d
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.data import ns3d
from sciml_pde_torch.models.fno import FNO2d, FNO3d, FNO3dAux
from sciml_pde_torch.ops.spectral import spectral_conv_3d, spectral_weight_init
from sciml_pde_torch.train.fno_train import run_training
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import assert_trees_close, precision, to_numpy_tree

SP, C, T0, MODES, WIDTH, NT = (8, 8, 12), 4, 3, 3, 8, 7


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    """Largest distance relative to the largest magnitude of ``want``."""
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_trees_rel(got, want, tol, what):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        err = _rel(have, leaf)
        assert err <= tol, f"{what}: {jax.tree_util.keystr(path)} off by {err:.3e} of its max"


# ---- spectral conv ------------------------------------------------------------

def _oracle_3d(x, ws, m1, m2, m3):
    """The definition in numpy (f64): rfftn, the four corner blocks, irfftn."""
    b, nx, ny, nz, _ = x.shape
    wc = [w[0] + 1j * w[1] for w in ws]
    xf = np.fft.rfftn(x, axes=(1, 2, 3))
    out = np.zeros((b, nx, ny, nz // 2 + 1, wc[0].shape[1]), dtype=np.complex128)
    for sx, sy, w in ((slice(0, m1), slice(0, m2), wc[0]),
                      (slice(nx - m1, nx), slice(0, m2), wc[1]),
                      (slice(0, m1), slice(ny - m2, ny), wc[2]),
                      (slice(nx - m1, nx), slice(ny - m2, ny), wc[3])):
        out[:, sx, sy, :m3] = np.einsum("bxyzi,ioxyz->bxyzo", xf[:, sx, sy, :m3], w)
    return np.fft.irfftn(out, s=(nx, ny, nz), axes=(1, 2, 3))


@pytest.fixture(scope="module")
def conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 10, 12, 3)).astype(np.float32)
    ws = [(rng.normal(size=(2, 3, 5, 3, 2, 4)) * 0.2).astype(np.float32) for _ in range(4)]
    cot = rng.normal(size=(2, 8, 10, 12, 5)).astype(np.float32)
    return x, ws, cot


@pytest.mark.parametrize("impl", ["dft2", "dft", "fft"])
def test_spectral_conv_3d_matches_jax_and_oracle(conv_inputs, impl):
    """Values and gradients of the port against JAX's same impl (f32 1e-5 of
    the largest magnitude) and the values against the numpy definition."""
    x, ws, cot = conv_inputs
    tx = torch.from_numpy(x).requires_grad_(True)
    tws = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    with precision("highest"):
        got = spectral_conv_3d(tx, *tws, 3, 2, 4, impl=impl)
        (got * torch.from_numpy(cot)).sum().backward()

        def f(x_, *w_):
            out = jax_spectral_conv_3d(x_, *w_, 3, 2, 4, impl=impl)
            return jnp.sum(out * cot), out
        grads, want = jax.jit(jax.grad(f, argnums=tuple(range(5)), has_aux=True))(
            jnp.asarray(x), *map(jnp.asarray, ws))
    assert got.shape == (2, 8, 10, 12, 5)
    assert _rel(got, want) <= 1e-5
    assert _rel(got, _oracle_3d(x.astype(np.float64), ws, 3, 2, 4)) <= 1e-5
    for name, g, w in zip(("dx", "dw1", "dw2", "dw3", "dw4"), [tx.grad] + [t.grad for t in tws],
                          grads):
        assert _rel(g, w) <= 1e-5, name


def test_default_precision_rounds_3d_dot_inputs(conv_inputs):
    """`default` rounds every product's inputs to bf16 (the 2D convention):
    within bf16's resolution of `highest`, and not equal to it."""
    x, ws, _ = conv_inputs
    args = (torch.from_numpy(x), *map(torch.from_numpy, ws), 3, 2, 4)
    for impl in ("dft2", "dft"):
        with precision("highest"):
            exact = spectral_conv_3d(*args, impl=impl)
        with precision("default"):
            rounded = spectral_conv_3d(*args, impl=impl)
        assert 0 < _rel(rounded, exact) < 2e-2


def test_spectral_weight_init_takes_three_mode_counts():
    w = spectral_weight_init(3, 5, 2, 3, 4, generator=torch.Generator().manual_seed(0))
    assert w.shape == (2, 3, 5, 2, 3, 4)
    assert 0 <= float(w.min()) and float(w.max()) < 1 / 15


# ---- models -------------------------------------------------------------------

def _grid3(b):
    g = jns3d.unit_grid_3d(*SP)
    return np.broadcast_to(g[None], (b, *SP, 3)).copy()


@pytest.fixture(scope="module")
def models3d():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *SP, T0, C)).astype(np.float32)
    xa = (rng.normal(size=(3, *SP, T0, C)) * 2 + 1).astype(np.float32)
    g, ga = _grid3(2), _grid3(3)
    kw = dict(num_channels=C, modes1=MODES, modes2=MODES, modes3=MODES, width=WIDTH,
              initial_step=T0)
    base, aux = FlaxFNO3d(**kw), FlaxFNO3dAux(**kw)
    pb = to_numpy_tree(jax.jit(base.init)(jax.random.PRNGKey(2), x, g)["params"])
    pa = to_numpy_tree(jax.jit(aux.init)(jax.random.PRNGKey(3), x, g, xa, ga)["params"])
    return base, pb, aux, pa, x, g, xa, ga


def _port(cls, tree, **kw):
    m = cls(C, MODES, MODES, MODES, WIDTH, T0, **kw)
    m.load_state_dict(flax_to_state_dict(tree))
    return m


def test_fno3d_matches_flax_values_and_grads(models3d):
    base, pb, _, _, x, g, _, _ = models3d
    cot = np.random.default_rng(4).normal(size=(2, *SP, 1, C)).astype(np.float32)
    model = _port(FNO3d, pb)
    with precision("highest"):
        want = jax.jit(lambda p: base.apply({"params": p}, x, g))(pb)
        gj = jax.jit(jax.grad(lambda p: jnp.sum(base.apply({"params": p}, x, g) * cot)))(pb)
        out = model(torch.from_numpy(x), torch.from_numpy(g))
        (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (2, *SP, 1, C)
    assert _rel(out, want) <= 1e-5
    _assert_trees_rel(state_dict_to_flax({k: p.grad for k, p in model.named_parameters()}),
                      to_numpy_tree(gj), 1e-4, "FNO3d grad")


def test_fno3d_aux_matches_flax_and_its_halves(models3d):
    _, _, aux, pa, x, g, xa, ga = models3d
    model = _port(FNO3dAux, pa)
    tx, tg, txa, tga = map(torch.from_numpy, (x, g, xa, ga))
    with precision("highest"):
        wp, wa = jax.jit(lambda p: aux.apply({"params": p}, x, g, xa, ga))(pa)
        gj = jax.jit(jax.grad(lambda p: sum(jnp.sum(o ** 2) for o in aux.apply(
            {"params": p}, x, g, xa, ga))))(pa)
        gp, gap = model(tx, tg, txa, tga)
        sum((o ** 2).sum() for o in (gp, gap)).backward()
        with torch.no_grad():
            hp, ha = model.primary(tx, tg), model.auxiliary(txa, tga)
    assert gp.shape == (2, *SP, 1, C) and gap.shape == (3, *SP, 1, C)
    assert _rel(gp, wp) <= 1e-5 and _rel(gap, wa) <= 1e-5
    assert _rel(hp, gp) <= 1e-6 and _rel(ha, gap) <= 1e-6
    _assert_trees_rel(state_dict_to_flax({k: p.grad for k, p in model.named_parameters()}),
                      to_numpy_tree(gj), 1e-4, "FNO3dAux grad")


def test_3d_tree_roundtrip(models3d):
    _, pb, _, pa, *_ = models3d
    for tree, cls in ((pb, FNO3d), (pa, FNO3dAux)):
        model = _port(cls, tree)
        back = state_dict_to_flax(model.state_dict())
        assert_trees_close(back, tree, 0, 0, f"{cls.__name__} roundtrip")
        assert sorted(back["backbone"]["conv0"]) == ["w1", "w2", "w3", "w4"]
        assert sorted(flax_to_state_dict(back)) == sorted(model.state_dict())


@pytest.mark.parametrize("ndim", [2, 3])
def test_remat_same_outputs_grads_and_keys(models3d, ndim):
    """remat=True recomputes each block in the backward pass: the same
    outputs and gradients as remat=False (1e-6 of the largest magnitude),
    the same state_dict keys, and flax's remat tree loads unchanged."""
    if ndim == 3:
        _, tree, _, _, x, g, _, _ = models3d
        make = lambda remat: _port(FNO3d, tree, remat=remat)  # noqa: E731
        flax_remat = FlaxFNO3d(num_channels=C, modes1=MODES, modes2=MODES, modes3=MODES,
                               width=WIDTH, initial_step=T0, remat=True)
    else:
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 16, 16, T0, 2)).astype(np.float32)
        g = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
        flax_remat = FlaxFNO2d(num_channels=2, modes1=4, modes2=4, width=WIDTH,
                               initial_step=T0, remat=True)
        tree = to_numpy_tree(jax.jit(flax_remat.init)(jax.random.PRNGKey(6), x, g)["params"])

        def make(remat):
            m = FNO2d(2, 4, 4, WIDTH, T0, remat=remat)
            m.load_state_dict(flax_to_state_dict(tree))
            return m
    remat_tree = jax.eval_shape(flax_remat.init, jax.random.PRNGKey(7), x, g)["params"]
    assert jax.tree_util.tree_structure(remat_tree) == jax.tree_util.tree_structure(tree)
    outs, grads = [], []
    for remat in (False, True):
        m = make(remat)
        out = m(torch.from_numpy(x), torch.from_numpy(g))
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in m.named_parameters()})
    assert sorted(make(True).state_dict()) == sorted(make(False).state_dict())
    assert _rel(outs[1], outs[0]) <= 1e-6
    for k in grads[0]:
        assert _rel(grads[1][k], grads[0][k]) <= 1e-6, k
    with precision("highest"):
        want = jax.jit(lambda p: flax_remat.apply({"params": p}, x, g))(tree)
        assert _rel(make(True)(torch.from_numpy(x), torch.from_numpy(g)), want) <= 1e-5


# ---- data ---------------------------------------------------------------------

def _write_pair(folder, seed, suffix, rng):
    with h5py.File(folder / f"v_trj_seed{seed}{suffix}.h5", "w") as f:
        f["data"] = rng.normal(size=(*SP, NT, 3)).astype(np.float32)
    with h5py.File(folder / f"s_trj_seed{seed}{suffix}.h5", "w") as f:
        f["data"] = rng.uniform(size=(NT, *SP)).astype(np.float32)


@pytest.fixture(scope="module")
def plume(tmp_path_factory):
    """Primary ``_interp`` seeds 0-2 and test seed 5; aux seeds 0-6."""
    d = tmp_path_factory.mktemp("plume")
    rng = np.random.default_rng(7)
    for s in (0, 1, 2, 5):
        _write_pair(d, s, "_interp", rng)
    for s in range(7):
        _write_pair(d, s, "", rng)
    return d


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("kw", [dict(), dict(with_aux=False),
                                dict(aux_store_dtype="bf16", store_dtype="bf16")],
                         ids=["aux", "baseline", "bf16"])
def test_load_ns3d_aux_matches_jax(plume, kw):
    kw = dict(train_subsample=(2, 2, 6), num_aux_samples=3, initial_step=T0,
              test_seeds=[5], **kw)
    want = jns3d.load_ns3d_aux(str(plume), **kw)
    got = ns3d.load_ns3d_aux(str(plume), device="cpu", **kw)
    for name in ("primary_train", "primary_test", "aux_train"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None
            continue
        assert str(g.data.dtype).split(".")[-1] == str(w.data.dtype), name
        np.testing.assert_array_equal(_bits(g.data), _bits(w.data), err_msg=name)
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.window_index(), np.asarray(w.window_index()))
    assert got.aux_row_map is None and got.primary_test.data.dtype == torch.float32


def test_load_ns3d_aux_too_few_seeds_raise_like_jax(plume):
    for kw, match in ((dict(train_subsample=(4, 4, 6)), "primary _interp seeds"),
                      (dict(train_subsample=(2, 2, 9)), "aux seeds available"),
                      (dict(train_subsample=(2, 3, 7)), "aux pool")):
        for load in (jns3d.load_ns3d_aux, ns3d.load_ns3d_aux):
            with pytest.raises(ValueError, match=match):
                load(str(plume), num_aux_samples=3, initial_step=T0, test_seeds=[5], **kw)


# ---- run_training -------------------------------------------------------------

COMMON = dict(dataset_family="ns3d", train_subsample=(2, 2, 6), test_range=(5, 6),
              num_aux_samples=3, modes=MODES, width=WIDTH, initial_step=T0, num_channels=C,
              batch_size=2, epochs=2, learning_rate=2e-3, learning_rate_share=2e-3,
              learning_rate_fc2=1e-3, log_every=0, seed=3)


def _jax_init(aux):
    kw = dict(num_channels=C, modes1=MODES, modes2=MODES, modes3=MODES, width=WIDTH,
              initial_step=T0)
    x0, g0 = jnp.zeros((1, *SP, T0, C)), jnp.zeros((1, *SP, 3))
    key = jax.random.PRNGKey(COMMON["seed"])
    if aux:
        return to_numpy_tree(FlaxFNO3dAux(**kw).init(key, x0, g0, x0, g0)["params"])
    return to_numpy_tree(FlaxFNO3d(**kw).init(key, x0, g0)["params"])


@pytest.fixture(scope="module")
def trained3d(plume, tmp_path_factory):
    out = tmp_path_factory.mktemp("ns3d_runs")
    runs = {}
    with precision("highest"):
        for aux in (False, True):
            kw = dict(COMMON, base_path=str(plume), if_aux=aux, model_name=f"NS3D_{aux}_FNO")
            want = jax_run_training(run_dir=str(out / "j"), **kw)
            got = run_training(run_dir=str(out / "t"), init_params=_jax_init(aux),
                               device="cpu", **kw)
            runs[aux] = (kw, want, got)
    return out, runs


@pytest.mark.parametrize("aux", [False, True], ids=["baseline", "aux"])
def test_run_training_ns3d_matches_jax(trained3d, aux):
    out, runs = trained3d
    kw, want, got = runs[aux]
    assert [h["epoch"] for h in got.history] == [h["epoch"] for h in want.history] == [0, 1]
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
    _assert_trees_rel(got.params, to_numpy_tree(want.params), 1e-4, "trained 3D tree")
    ck = restore_checkpoint(out / "t" / f"{kw['model_name']}_ckpt")
    assert ck["params"]["backbone"]["conv0"]["w4"].shape == (2, WIDTH, WIDTH, *(MODES,) * 3)


@pytest.mark.parametrize("aux", [False, True], ids=["baseline", "aux"])
def test_ns3d_eval_matches_jax(trained3d, aux):
    """if_training=False from JAX's checkpoint (its tree in the port's
    format): the pickle and npz JAX writes, on the 3D test seed."""
    from sciml_pde_tpu.utils.checkpoint import restore_params

    out, runs = trained3d
    kw = runs[aux][0]
    name = kw["model_name"]
    tree, best = restore_params(out / "j" / f"{name}_ckpt")
    save_checkpoint(out / "tj" / f"{name}_ckpt", to_numpy_tree(tree), {}, 0, best)
    ev = dict(kw, if_training=False, rollout_test=2, iLow=1, iHigh=3)
    with precision("highest"):
        jax_run_training(run_dir=str(out / "j"), **ev)
        got = run_training(run_dir=str(out / "tj"), device="cpu", **ev)
    pj, pt = (pickle.loads((out / w / f"{name}.pickle").read_bytes()) for w in ("j", "tj"))
    assert len(pt) == 6 and all(type(v) is np.float64 for v in pt)
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    assert got.best_val == pt[1]
    mj, mt = (np.load(out / w / f"{name}_mse_time.npz")["mse"] for w in ("j", "tj"))
    np.testing.assert_allclose(mt, mj, rtol=1e-4)


def test_fast_step_refuses_3d_like_jax(plume, tmp_path):
    kw = dict(COMMON, base_path=str(plume), epochs=1)
    for train in (jax_run_training, run_training):
        extra = {} if train is jax_run_training else dict(device="cpu")
        with pytest.raises(ValueError, match="only the 2D FNO"):
            train(run_dir=str(tmp_path), fast_step=True, **kw, **extra)
