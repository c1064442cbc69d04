"""Port of the NS-2D FNO paths vs the JAX package's: ``load_ns_baseline`` and
``load_ns_aux`` on tiny HDF5 files in the JAX schema (the per-file row map,
a fraction of file 0, too few aux files, bf16 stores bit for bit, the
upsample on load and ``aux_upsample_at_gather``), the aux step with a row
map under ``aux_chunks`` 1, 2, 4, ``aux_resize_to`` and ``aux_native_grid``
(the antialiased grid downsample), ``run_training(dataset_family="ns")``
for two epochs (baseline on the production and the fused step, aux with
and without the store knobs), the NS evaluation, and ``cli train --config
config_ns`` with ``sim_name`` / ``test_range`` overrides.

Tolerances: f32 1e-5 (the upsample 1e-6) of the largest magnitude; losses,
metrics and histories 1e-4 relative; trained trees 1e-4 of each leaf's
largest magnitude, as in test_torch_aux.py (the fused step's plain
versions as in test_torch_train.py)."""

import pickle

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import ns as jns
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.models import FNO2dAux as FlaxFNO2dAux
from sciml_pde_tpu.train import optim as joptim
from sciml_pde_tpu.train.fno_train import build_aux_step as jax_build_aux_step
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.data import ns
from sciml_pde_torch.data.dr import resize_linear
from sciml_pde_torch.models.fno import FNO2dAux
from sciml_pde_torch.train import optim
from sciml_pde_torch.train.fno_train import build_aux_step, run_training
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import precision, to_numpy_tree

X, XA, S, NT, C, T0, NA, MODES, WIDTH = 16, 8, 2, 8, 3, 4, 2, 4, 8
SIM, AUX = "ns_incom_inhom_2d_256", "ns_aux_2d_256"


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a, dtype=np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _bits(a):
    """bf16 arrays as their uint16 bits, others as they are."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _assert_trees_rel(got, want, tol, what):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        err = _rel(have, leaf)
        assert err <= tol, f"{what}: {jax.tree_util.keystr(path)} off by {err:.3e} of its max"


def _write_ns(path, n, x, seed):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["velocity"] = rng.normal(size=(n, NT, x, x, 2)).astype(np.float32)
        f["particles"] = rng.uniform(size=(n, NT, x, x, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Primary files 0, 1 and test file 250 (S trajectories each, 16^2);
    aux files 0-3 at 16^2 under ``same/`` and at 8^2 under ``low/``."""
    d = tmp_path_factory.mktemp("ns")
    for i in (0, 1, 250):
        _write_ns(d / f"{SIM}-{i}.h5", S, X, seed=i)
    for sub, x in (("same", X), ("low", XA)):
        (d / sub).mkdir()
        for i in range(4):
            _write_ns(d / sub / f"{AUX}-{i}.h5", S, x, seed=100 + i + x)
    return d


# ---- data ---------------------------------------------------------------------

AUX_CASES = {
    "row_map": dict(),
    "fraction": dict(train_subsample=(1, 0.5, 4)),
    "upsample_on_load": dict(aux="low", if_downsample=True),
    "upsample_at_gather": dict(aux="low", aux_upsample_at_gather=True),
    "bf16": dict(aux_store_dtype="bf16", store_dtype="bf16"),
    "bf16_upsampled": dict(aux="low", aux_store_dtype="bf16"),
}


@pytest.mark.parametrize("case", AUX_CASES.values(), ids=AUX_CASES.keys())
def test_load_ns_aux_matches_jax(folder, case):
    """Every store, grid, window index and the row map against JAX's loader:
    f32 and bf16 stores bit for bit, an aux store upsampled on load within
    1e-6 of the largest magnitude (bf16: one bf16 step)."""
    case = dict(case)
    sub = case.pop("aux", "same")
    kw = dict(dict(train_subsample=(2, 2, 4), num_aux_samples=NA, initial_step=T0,
                   test_range=(250, 251)), **case)
    want = jns.load_ns_aux(str(folder), str(folder / sub), **kw)
    got = ns.load_ns_aux(str(folder), str(folder / sub), device="cpu", **kw)
    np.testing.assert_array_equal(got.aux_row_map, want.aux_row_map)
    assert got.aux_row_map.dtype == np.int32
    for name in ("primary_train", "primary_test", "aux_train"):
        w, g = getattr(want, name), getattr(got, name)
        assert str(g.data.dtype).split(".")[-1] == str(w.data.dtype), name
        assert tuple(g.data.shape) == tuple(w.data.shape), name
        if name == "aux_train" and sub == "low" and not case.get("aux_upsample_at_gather"):
            tol = 2 ** -7 if "aux_store_dtype" in case else 1e-6
            assert _rel(g.data, w.data) <= tol
        else:
            np.testing.assert_array_equal(_bits(g.data), _bits(w.data), err_msg=name)
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.window_index(), np.asarray(w.window_index()))
    if case.get("aux_upsample_at_gather"):
        assert got.aux_train.data.shape[2:4] == (XA, XA)


def test_row_map_pairs_files_as_jax_documents(folder):
    got = ns.load_ns_aux(str(folder), str(folder / "same"), train_subsample=(2, 2, 4),
                         num_aux_samples=NA, initial_step=T0, test_range=(250, 251),
                         device="cpu")
    # file f, trajectory b -> aux files f*nA + j, trajectory b
    np.testing.assert_array_equal(got.aux_row_map, [[0, 2], [1, 3], [4, 6], [5, 7]])


def test_too_few_aux_files_raise_like_jax(folder):
    kw = dict(train_subsample=(2, 2, 3), num_aux_samples=NA, initial_step=T0,
              test_range=(250, 251))
    for load, extra in ((jns.load_ns_aux, {}), (ns.load_ns_aux, dict(device="cpu"))):
        with pytest.raises(ValueError, match="need 4 aux files"):
            load(str(folder), str(folder / "same"), **kw, **extra)


@pytest.mark.parametrize("kw", [dict(train_subsample=2), dict(train_subsample=0.5),
                                dict(train_subsample=2, store_dtype="bf16")],
                         ids=["files", "fraction", "bf16"])
def test_load_ns_baseline_matches_jax(folder, kw):
    kw = dict(initial_step=T0, rollout_test=2, test_range=(250, 251), **kw)
    want = jns.load_ns_baseline(str(folder), **kw)
    got = ns.load_ns_baseline(str(folder), device="cpu", **kw)
    for name in ("train", "test"):
        w, g = getattr(want, name), getattr(got, name)
        assert str(g.data.dtype).split(".")[-1] == str(w.data.dtype), name
        np.testing.assert_array_equal(_bits(g.data), _bits(w.data), err_msg=name)
    assert got.test.data.shape[1] == T0 + 2


def test_grid_downsample_antialiases_like_jax():
    """The native aux grid: JAX's linear resize of the primary grid down
    (256^2 -> 128^2 at production), which antialiases; F.interpolate does
    not."""
    grid = ns.unit_grid(X, X)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (XA, XA, 2), method="linear"))
    got = resize_linear(torch.from_numpy(grid), {0: XA, 1: XA})
    assert _rel(got, want) <= 1e-6
    naive = torch.nn.functional.interpolate(torch.from_numpy(grid).permute(2, 0, 1)[None],
                                            size=(XA, XA), mode="bilinear",
                                            align_corners=False)[0].permute(1, 2, 0)
    assert _rel(naive, want) > 1e-3


# ---- the aux step -------------------------------------------------------------

STEP_CASES = {
    "chunks1": dict(aux_chunks=1),
    "chunks2": dict(aux_chunks=2),
    "chunks4": dict(aux_chunks=4),
    "resize_to": dict(aux_res=XA, aux_resize_to=(X, X)),
    "resize_to_chunks2": dict(aux_res=XA, aux_resize_to=(X, X), aux_chunks=2),
    "native_grid": dict(aux_res=XA, native=True),
    "bf16_native_grid": dict(aux_res=XA, native=True, bf16=True),
}


@pytest.mark.parametrize("case", STEP_CASES.values(), ids=STEP_CASES.keys())
def test_aux_step_matches_jax_with_row_map(case):
    """Three aux steps from one tree on the device stores, paired by a
    shuffled row map (2 primary x 2 aux windows a step): loss, lp, la and
    the grad norm each step, then the primary validation loss, Adam's first
    moments and the tree."""
    case = dict(case)
    ar = case.pop("aux_res", X)
    native, bf16 = case.pop("native", False), case.pop("bf16", False)
    rng = np.random.default_rng(9)
    prim = rng.normal(size=(3, NT, X, X, C)).astype(np.float32)
    aux = (rng.normal(size=(3 * NA, NT, ar, ar, C)) * 0.5).astype(np.float32)
    row_map = rng.permutation(3 * NA).reshape(3, NA).astype(np.int32)
    grid = ns.unit_grid(X, X)
    if bf16:
        aux_j = jnp.asarray(aux).astype(jnp.bfloat16)
        aux_t = torch.from_numpy(aux).to(torch.bfloat16)
    else:
        aux_j, aux_t = jnp.asarray(aux), torch.from_numpy(aux)
    if native:
        case["aux_native_grid"] = jax.image.resize(jnp.asarray(grid), (ar, ar, 2), "linear")
    flax_model = FlaxFNO2dAux(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH,
                              initial_step=T0)
    x0 = jnp.zeros((1, X, X, T0, C))
    params = to_numpy_tree(jax.jit(flax_model.init)(jax.random.PRNGKey(1), x0,
                                                    jnp.zeros((1, X, X, 2)), x0,
                                                    jnp.zeros((1, X, X, 2)))["params"])
    lrs = {"shared": 2e-3, "primary_head": 1e-3, "aux_head": 1e-3}
    batches = [np.array([[0, 1], [2, 3]]), np.array([[1, 2], [0, 0]]),
               np.array([[2, 1], [1, 3]])]
    with precision("highest"):
        tx = joptim.make_grouped_optimizer(joptim.aux_group_of, lrs, 6)
        jstep, jval = jax_build_aux_step(flax_model, tx, T0, 1, NA, 0.7, aux_row_map=row_map,
                                         **case)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jst = tx.init(jp)
        model = FNO2dAux(C, MODES, MODES, WIDTH, T0)
        model.load_state_dict(flax_to_state_dict(params))
        opt = optim.make_grouped_optimizer(dict(model.named_parameters()), optim.aux_group_of,
                                           lrs, 6)
        if native:
            case["aux_native_grid"] = torch.from_numpy(np.asarray(case["aux_native_grid"]))
        step, val = build_aux_step(model, opt, T0, 1, NA, 0.7, aux_row_map=row_map, **case)
        tprim, tgrid = torch.from_numpy(prim), torch.from_numpy(grid)
        for idx in batches:
            jp, jst, jl, jg = jstep(jp, jst, jnp.asarray(prim), aux_j, jnp.asarray(grid),
                                    jnp.asarray(idx, jnp.int32))
            tl, tg = step(tprim, aux_t, tgrid, torch.from_numpy(idx).long())
            for name, g, w in zip(("loss", "lp", "la"), tl, jl):
                np.testing.assert_allclose(float(g), float(w), rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(float(tg), float(jg), rtol=1e-4, err_msg="g_norm")
        vidx = np.array([[0, 0], [1, 0], [2, 0]])
        np.testing.assert_allclose(float(val(tprim, tgrid, torch.from_numpy(vidx).long())),
                                   float(jval(jp, jnp.asarray(prim), jnp.asarray(grid),
                                              jnp.asarray(vidx, jnp.int32))), rtol=1e-4)
    # Adam's first moment per leaf; the parameters against the tree's largest
    # magnitude: Adam's update lr * g / (|g| + 1e-8) turns the f32 noise of a
    # gradient near 1e-8 (spectral weights reach 2e-10 here) into up to 1.2e-4
    # of a spectral leaf's own largest magnitude, with every gradient within
    # 1.6e-6 of JAX's (the same reading as chip_smoke.py phase 4b)
    mu = _jax_adam_mu(jst)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state_dict_to_flax(opt.m)):
        key = jax.tree_util.keystr(path)
        assert _rel(leaf, mu[key]) <= 1e-5, f"first moment {key}"
    want = to_numpy_tree(jp)
    top = max(np.abs(v).max() for v in jax.tree_util.tree_leaves(want))
    got = state_dict_to_flax(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        assert np.abs(_np(have) - leaf).max() <= 1e-4 * top, jax.tree_util.keystr(path)


def _jax_adam_mu(state) -> dict:
    """optax's Adam first moments of a grouped optimizer, merged over the
    groups: keystr(path) -> array."""
    import optax

    mu = {}
    for a in jax.tree_util.tree_leaves(state,
                                       is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState)):
        if not isinstance(a, optax.ScaleByAdamState):
            continue
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                a.mu, is_leaf=lambda n: isinstance(n, optax.MaskedNode)):
            if not isinstance(leaf, optax.MaskedNode):
                mu[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return mu


def test_aux_modes_are_exclusive_and_chunks_divide():
    model = FNO2dAux(C, MODES, MODES, WIDTH, T0)
    opt = optim.make_grouped_optimizer(dict(model.named_parameters()), optim.aux_group_of,
                                       {"shared": 1e-3, "primary_head": 1e-3,
                                        "aux_head": 1e-3}, 2)
    with pytest.raises(ValueError, match="exclusive"):
        build_aux_step(model, opt, T0, 1, NA, 0.7, aux_resize_to=(X, X),
                       aux_native_grid=torch.zeros(XA, XA, 2))
    step, _ = build_aux_step(model, opt, T0, 1, NA, 0.7, aux_chunks=3)
    data = torch.zeros(2 * NA, NT, X, X, C)
    with pytest.raises(ValueError, match="not divisible by aux_chunks=3"):
        step(data[:2], data, torch.zeros(X, X, 2), torch.tensor([[0, 0], [1, 0]]))


# ---- run_training -------------------------------------------------------------

COMMON = dict(dataset_family="ns", test_range=(250, 251), train_subsample=(2, 2, 4),
              num_aux_samples=NA, modes=MODES, width=WIDTH, initial_step=T0, num_channels=C,
              batch_size=4, epochs=2, learning_rate=2e-3, learning_rate_share=2e-3,
              learning_rate_fc2=1e-3, log_every=0, seed=3)

RUNS = {
    "baseline": dict(if_aux=False, fast_step=False),
    "fused": dict(if_aux=False, fast_step=True),
    "aux": dict(if_aux=True),
    "aux_knobs": dict(if_aux=True, aux="low", aux_upsample_at_gather=True,
                      aux_native_compute=True, aux_chunks=2, aux_store_dtype="bf16",
                      primary_store_dtype="bf16", fno_remat=True),
    "aux_upsampled_in_step": dict(if_aux=True, aux="low", aux_upsample_at_gather=True,
                                  aux_chunks=2),
}


def _jax_init(aux):
    x0, g0 = jnp.zeros((1, X, X, T0, C)), jnp.zeros((1, X, X, 2))
    key = jax.random.PRNGKey(COMMON["seed"])
    kw = dict(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH, initial_step=T0)
    if aux:
        return to_numpy_tree(jax.jit(FlaxFNO2dAux(**kw).init)(key, x0, g0, x0, g0)["params"])
    return to_numpy_tree(jax.jit(FlaxFNO2d(**kw).init)(key, x0, g0)["params"])


def _run_kw(folder, name, case):
    case = dict(case)
    sub = case.pop("aux", "same")
    return dict(COMMON, base_path=str(folder), aux_path=str(folder / sub),
                model_name=f"NS_{name}_FNO", **case)


@pytest.mark.parametrize("name", RUNS, ids=RUNS.keys())
def test_run_training_ns_matches_jax(folder, tmp_path, name):
    """Two epochs from JAX's init tree in both packages: train and val loss
    per epoch, the trained tree, and the best-val checkpoint."""
    kw = _run_kw(folder, name, RUNS[name])
    fused = kw.get("fast_step", False)
    with precision("highest"):
        want = jax_run_training(run_dir=str(tmp_path / "j"), **kw)
        got = run_training(run_dir=str(tmp_path / "t"), init_params=_jax_init(kw["if_aux"]),
                           device="cpu", **kw)
    assert len(got.history) == len(want.history) == kw["epochs"]
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
    _assert_trees_rel(got.params, to_numpy_tree(want.params), 1e-4, f"{name} tree")
    ck = restore_checkpoint(tmp_path / "t" / f"{kw['model_name']}_ckpt")
    ost = ck["opt_state"]  # the fused step's FlatOptState, or optax's chain
    assert (isinstance(ost, dict) and isinstance(ost["m"], torch.Tensor)) is fused
    heads = ["backbone", "fc2_auxiliary", "fc2_primary"] if kw["if_aux"] else ["backbone", "fc2"]
    assert sorted(ck["params"]) == heads


def test_ns_eval_matches_jax(folder, tmp_path):
    """if_training=False on the NS test file, from one tree in both formats:
    the pickle and npz JAX writes."""
    from sciml_pde_tpu.utils.checkpoint import save_checkpoint as jax_save

    tree = _jax_init(False)
    kw = dict(_run_kw(folder, "eval", dict(if_aux=False)), if_training=False, rollout_test=3,
              iLow=1, iHigh=3)
    name = kw["model_name"]
    jax_save(tmp_path / "j" / f"{name}_ckpt", jax.tree_util.tree_map(jnp.asarray, tree),
             joptim.make_optimizer(1e-3, 1).init(jax.tree_util.tree_map(jnp.asarray, tree)),
             0, 1.0)
    save_checkpoint(tmp_path / "t" / f"{name}_ckpt", tree, {}, 0, 1.0)
    with precision("highest"):
        jax_run_training(run_dir=str(tmp_path / "j"), **kw)
        got = run_training(run_dir=str(tmp_path / "t"), device="cpu", **kw)
    pj, pt = (pickle.loads((tmp_path / w / f"{name}.pickle").read_bytes()) for w in "jt")
    assert len(pt) == 6 and all(type(v) is np.float64 for v in pt)
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    assert got.best_val == pt[1]
    mj, mt = (np.load(tmp_path / w / f"{name}_mse_time.npz")["mse"] for w in "jt")
    assert mt.shape == (3,)
    np.testing.assert_allclose(mt, mj, rtol=1e-4)


def test_dr_refuses_ns_store_options(tmp_path):
    """The DR loaders take none of the NS store options: the port refuses
    them before reading anything (JAX ignores them)."""
    for opt in (dict(aux_store_dtype="bf16"), dict(primary_store_dtype="bf16"),
                dict(aux_upsample_at_gather=True)):
        with pytest.raises(ValueError, match="NS-family store options"):
            run_training(base_path=str(tmp_path), if_aux=True, device="cpu", **opt)


def test_cli_train_config_ns_overrides_land(folder, tmp_path):
    """``cli train --config config_ns`` with ``sim_name`` and ``test_range``
    overrides: the files of another name train (the config's defaults name
    none of them), then ``if_training=False`` scores that test file."""
    from sciml_pde_torch.train import cli

    d = tmp_path / "data"
    d.mkdir()
    for i in (0, 7):
        _write_ns(d / f"ns_custom-{i}.h5", S, X, seed=50 + i)
    args = ["--config", "config_ns", f"base_path={d}/", "sim_name=ns_custom",
            "test_range=(7, 8)", "train_subsample=[1, 1, 24]", f"run_dir={tmp_path}",
            "model_name=NS_custom_FNO", "epochs=1", "width=8", "modes=4", "initial_step=4",
            "batch_size=4", "log_every=0", "device=cpu"]
    res = cli.main(args)
    assert np.isfinite(res.best_val) and len(res.history) == 1
    ck = restore_checkpoint(tmp_path / "NS_custom_FNO_ckpt")
    assert ck["params"]["fc2"]["Dense_0"]["kernel"].shape == (128, C)
    ev = cli.main(args + ["if_training=False", "rollout_test=2", "iLow=1", "iHigh=3"])
    assert np.isfinite(ev.best_val)
    assert np.load(tmp_path / "NS_custom_FNO_mse_time.npz")["mse"].shape == (2,)
