"""Port of DR aux joint training vs the JAX package's: the trilinear resize,
the aux and merged loaders on tiny HDF5 files, FNO2dAux and its weight
conversion, the grouped optimizer, build_aux_step, run_training(if_aux=True)
over two epochs from JAX's init tree, its evaluation, and the port's
``aux`` CLI -> if_training=False -> collect flow.

Tolerances: f32 1e-5 (relative to the largest magnitude where stated);
1e-4 relative where the FNO's DFT sets the error (model outputs, losses,
metrics), as in test_torch_train.py, and for trained trees 1e-4 of each
leaf's largest magnitude (two epochs here read 1.7e-5)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_tpu.data import dr as jdr
from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import FNO2dAux as FlaxFNO2dAux
from sciml_pde_tpu.train import optim as joptim
from sciml_pde_tpu.train.fno_train import build_aux_step as jax_build_aux_step
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.data import dr
from sciml_pde_torch.models.fno import FNO2dAux
from sciml_pde_torch.train import optim
from sciml_pde_torch.train.fno_train import build_aux_step, run_training
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from _torch_parity import assert_trees_close, precision, to_numpy_tree

NT, X, C, T0, MODES, WIDTH, NA = 12, 16, 2, 4, 4, 8, 3
COMMON = dict(train_subsample=(4, 2, 6), modes=MODES, width=WIDTH, initial_step=T0,
              num_channels=C, batch_size=2, epochs=2, num_aux_samples=NA,
              auxiliary_weight=0.7, learning_rate_share=2e-3, learning_rate_fc2=1e-3,
              log_every=0, seed=3)


def _write(path, n, nt, x, seed, start=0):
    rng = np.random.default_rng(seed)
    lin = np.linspace(0, 1, x, dtype=np.float32)
    for s in range(start, start + n):
        write_seed_group(path, s, rng.normal(size=(nt, x, x, C)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, nt, dtype=np.float32))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Primary (10 seeds: 9 train, 1 test), an extension file, the
    decomposed aux file and its downsampled copy (T 6, 12^2)."""
    d = tmp_path_factory.mktemp("dr_aux")
    _write(d / dr.PRIMARY_FILE, 10, NT, X, seed=0)
    _write(d / "2D_diff-react_ext.h5", 4, NT, X, seed=1, start=100)
    _write(d / dr.AUX_FILE, 8, NT, X, seed=2)
    _write(d / dr.AUX_FILE_DOWNSAMPLED, 8, 6, 12, seed=3)
    return d


def _flax_init(seed=COMMON["seed"]):
    model = FlaxFNO2dAux(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH,
                         initial_step=T0)
    x0, g0 = jnp.zeros((1, X, X, T0, C)), jnp.zeros((1, X, X, 2))
    return model, to_numpy_tree(model.init(jax.random.PRNGKey(seed), x0, g0, x0, g0)["params"])


def _assert_trees_rel(got, want, tol, what):
    """Every leaf of ``want`` against ``got`` within ``tol`` of the leaf's
    largest magnitude."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        have = have.numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
        err = np.abs(have - np.asarray(leaf)).max() / np.abs(leaf).max()
        assert err <= tol, f"{what}: {jax.tree_util.keystr(path)} off by {err:.3e} of its max"


# ---- data --------------------------------------------------------------------

@pytest.mark.parametrize("src, dst", [
    ((5, 12, 9), (11, 16, 16)),   # every axis grows (the downsampled file's 50 -> 101, 96 -> 128)
    ((6, 16, 12), (4, 12, 16)),   # T and H shrink (JAX antialiases), W grows
], ids=["up", "down"])
def test_resize_trilinear_matches_jax(src, dst):
    data = np.random.default_rng(5).normal(size=(2, *src, C)).astype(np.float32)
    want = np.asarray(jdr._resize_trilinear(data, dst))
    got = dr._resize_trilinear(data, dst, device="cpu")
    assert got.shape == (2, *dst, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if src[0] < dst[0] and src[1] < dst[1] and src[2] < dst[2]:
        # growing on every axis it is torch's trilinear interpolation
        ti = torch.nn.functional.interpolate(torch.from_numpy(data).permute(0, 4, 1, 2, 3),
                                             size=dst, mode="trilinear", align_corners=False)
        np.testing.assert_allclose(got.numpy(), ti.permute(0, 2, 3, 4, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(), dict(if_downsample=True), dict(extra_train_files=["2D_diff-react_ext.h5"],
                                           train_subsample=(4, 11, 30)),
], ids=["same_res", "downsampled", "extension"])
def test_load_dr_aux_matches_jax(folder, kw):
    kw = dict(dict(train_subsample=(4, 2, 6), num_aux_samples=NA, initial_step=T0), **kw)
    if kw["train_subsample"][2] == 30:
        kw["num_aux_samples"] = 2  # 11 primary x 2 > 8 aux rows: raises in both
        with pytest.raises(ValueError, match="aux pool"):
            jdr.load_dr_aux(str(folder), **kw)
        with pytest.raises(ValueError, match="aux pool"):
            dr.load_dr_aux(str(folder), device="cpu", **kw)
        kw["num_aux_samples"] = 0
    want = jdr.load_dr_aux(str(folder), **kw)
    got = dr.load_dr_aux(str(folder), device="cpu", **kw)
    for name in ("primary_train", "primary_test", "aux_train"):
        w, g = getattr(want, name), getattr(got, name)
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(g.window_index(), np.asarray(w.window_index()))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))


@pytest.mark.parametrize("kw", [
    dict(train_subsample=12, extra_train_files=["2D_diff-react_ext.h5"]),
    dict(train_subsample=128, leaky_clip=True),
    dict(train_subsample=0.5, leaky_clip=True),
], ids=["extension", "leaky_clip", "leaky_fraction"])
def test_merged_pool_matches_jax(folder, kw):
    want = jdr.load_dr_baseline(str(folder), initial_step=T0, **kw)
    got = dr.load_dr_baseline(str(folder), initial_step=T0, device="cpu", **kw)
    assert got.train.num_trajectories == want.train.num_trajectories
    np.testing.assert_array_equal(got.train.data.numpy(), np.asarray(want.train.data))
    np.testing.assert_array_equal(got.test.data.numpy(), np.asarray(want.test.data))


def test_merged_pool_too_small_raises_like_jax(folder):
    kw = dict(train_subsample=20, extra_train_files=["2D_diff-react_ext.h5"], initial_step=T0)
    with pytest.raises(ValueError, match="extension files"):
        jdr.load_dr_baseline(str(folder), **kw)
    with pytest.raises(ValueError, match="extension files"):
        dr.load_dr_baseline(str(folder), device="cpu", **kw)


# ---- model, weights, optimizer ------------------------------------------------

@pytest.fixture(scope="module")
def model_setup():
    flax_model, params = _flax_init(seed=1)
    model = FNO2dAux(C, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, X, X, T0, C)).astype(np.float32)
    xa = rng.normal(size=(6, X, X, T0, C)).astype(np.float32) * 2 + 1
    g = rng.normal(size=(2, X, X, 2)).astype(np.float32)
    ga = np.broadcast_to(g[:1], (6, X, X, 2)).copy()
    return flax_model, params, model, x, g, xa, ga


def test_aux_tree_roundtrip(model_setup):
    _, params, model, *_ = model_setup
    back = state_dict_to_flax(model.state_dict())
    assert sorted(back) == sorted(params) == ["backbone", "fc2_auxiliary", "fc2_primary"]
    assert_trees_close(back, params, 0, 0, "aux roundtrip")
    assert sorted(flax_to_state_dict(back)) == sorted(model.state_dict())


def test_fno2d_aux_matches_flax_and_its_halves(model_setup):
    flax_model, params, model, x, g, xa, ga = model_setup
    with precision("highest"), torch.no_grad():
        wp, wa = flax_model.apply({"params": params}, x, g, xa, ga)
        tx, tg, txa, tga = map(torch.from_numpy, (x, g, xa, ga))
        gp, ga_out = model(tx, tg, txa, tga)
        for impl in ("dft", "fft"):
            p_i, a_i = model(tx, tg, txa, tga, impl=impl)
            np.testing.assert_allclose(p_i.numpy(), gp.numpy(), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(a_i.numpy(), ga_out.numpy(), rtol=1e-4, atol=1e-5)
        # the two heads alone compute the joint call's halves
        np.testing.assert_allclose(model.primary(tx, tg).numpy(), gp.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(model.auxiliary(txa, tga).numpy(), ga_out.numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert gp.shape == (2, X, X, 1, C) and ga_out.shape == (6, X, X, 1, C)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ga_out.numpy(), np.asarray(wa), rtol=1e-4, atol=1e-4)


def test_grouped_optimizer_matches_optax(model_setup):
    """Three updates with seeded gradients (one scaled past the clip): the
    global-norm clip, then L2, Adam and each group's cosine schedule."""
    _, params, model, *_ = model_setup
    lrs = {"shared": 3e-3, "primary_head": 1e-3, "aux_head": 5e-4}
    tx = joptim.make_grouped_optimizer(joptim.aux_group_of, lrs, 10)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(jp)
    tp = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = optim.make_grouped_optimizer(tp, optim.aux_group_of, lrs, 10)
    assert {g: len(n) for g, n in opt.groups.items()} == {"shared": 20, "primary_head": 2,
                                                          "aux_head": 2}
    rng = np.random.default_rng(7)
    for scale in (1.0, 100.0, 0.5):
        gtree = jax.tree_util.tree_map(
            lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), params)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, gtree), state, jp)
        jp = optax.apply_updates(jp, upd)
        g_norm = opt.step(tp, flax_to_state_dict(gtree))
        np.testing.assert_allclose(float(g_norm), float(optax.global_norm(gtree)), rtol=1e-5)
    assert opt.count == 3
    assert_trees_close(state_dict_to_flax(tp), to_numpy_tree(jp), 1e-5, 1e-7, "grouped adam")


def test_aux_step_matches_jax_step_for_step(model_setup):
    """Four aux steps on the device stores (DR pairing p * nA + j, the
    grouped optimizer): loss, lp, la and g_norm each step, then the tree and
    the primary validation loss."""
    flax_model, params, *_ = model_setup
    rng = np.random.default_rng(8)
    prim = rng.normal(size=(3, NT, X, X, C)).astype(np.float32)
    aux = rng.normal(size=(3 * NA, NT, X, X, C)).astype(np.float32) * 0.5
    grid = rng.normal(size=(X, X, 2)).astype(np.float32)
    batches = [np.array([[0, 1], [2, 5]]), np.array([[1, 7], [0, 0]]),
               np.array([[2, 2], [1, 3]]), np.array([[0, 6], [2, 0]])]
    lrs = {"shared": 2e-3, "primary_head": 1e-3, "aux_head": 1e-3}
    with precision("highest"):
        tx = joptim.make_grouped_optimizer(joptim.aux_group_of, lrs, 8)
        jstep, jval = jax_build_aux_step(flax_model, tx, T0, 1, NA, 0.7)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jst = tx.init(jp)
        model = FNO2dAux(C, MODES, MODES, WIDTH, T0)
        model.load_state_dict(flax_to_state_dict(params))
        opt = optim.make_grouped_optimizer(dict(model.named_parameters()), optim.aux_group_of,
                                           lrs, 8)
        step, val = build_aux_step(model, opt, T0, 1, NA, 0.7)
        tprim, taux, tgrid = map(torch.from_numpy, (prim, aux, grid))
        for idx in batches:
            jp, jst, jl, jg = jstep(jp, jst, jnp.asarray(prim), jnp.asarray(aux),
                                    jnp.asarray(grid), jnp.asarray(idx, jnp.int32))
            tl, tg = step(tprim, taux, tgrid, torch.from_numpy(idx).long())
            for name, g, w in zip(("loss", "lp", "la"), tl, jl):
                np.testing.assert_allclose(float(g), float(w), rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(float(tg), float(jg), rtol=1e-4, err_msg="g_norm")
        vidx = np.array([[0, 0], [1, 0], [2, 0]])
        np.testing.assert_allclose(float(val(tprim, tgrid, torch.from_numpy(vidx).long())),
                                   float(jval(jp, jnp.asarray(prim), jnp.asarray(grid),
                                              jnp.asarray(vidx, jnp.int32))), rtol=1e-4)
    _assert_trees_rel(state_dict_to_flax(model.state_dict()), to_numpy_tree(jp), 1e-4,
                      "params after four aux steps")


# ---- run_training --------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(folder, tmp_path_factory):
    """Two epochs of aux joint training in both packages from JAX's init."""
    out = tmp_path_factory.mktemp("aux_runs")
    kw = dict(COMMON, base_path=str(folder) + "/", aux_path=str(folder) + "/",
              model_name="DR_ds4_FNO")
    with precision("highest"):
        want = jax_run_training(if_aux=True, run_dir=str(out / "j"), **kw)
        got = run_training(if_aux=True, run_dir=str(out / "t"), init_params=_flax_init()[1],
                           device="cpu", **kw)
    return out, kw, want, got


def test_run_training_aux_matches_jax_over_two_epochs(trained):
    out, _, want, got = trained
    assert [h["epoch"] for h in got.history] == [h["epoch"] for h in want.history] == [0, 1]
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
    _assert_trees_rel(got.params, to_numpy_tree(want.params), 1e-4, "trained aux tree")
    # the checkpoint follows the best primary validation loss
    ck = restore_checkpoint(out / "t" / "DR_ds4_FNO_ckpt")
    best = min(range(2), key=lambda i: got.history[i]["val_loss"])
    assert ck["meta"]["epoch"] == best
    np.testing.assert_allclose(ck["meta"]["loss"], got.history[best]["val_loss"], rtol=1e-6)
    assert sorted(ck["params"]) == ["backbone", "fc2_auxiliary", "fc2_primary"]
    adam = ck["opt_state"][1]["inner_states"]["shared"]["inner_state"][1]  # optax's partition
    assert isinstance(adam["mu"], dict) and adam["count"] > 0
    assert (out / "t" / "DR_ds4_FNO.jsonl").exists()


def test_aux_eval_scores_the_primary_head_like_jax(trained):
    """if_training=False from JAX's aux checkpoint (its tree copied into the
    port's checkpoint format): the pickle and npz JAX writes."""
    from sciml_pde_tpu.utils.checkpoint import restore_params

    out, kw, _, _ = trained
    tree, best = restore_params(out / "j" / "DR_ds4_FNO_ckpt")
    save_checkpoint(out / "tj" / "DR_ds4_FNO_ckpt", to_numpy_tree(tree), {}, 0, best)
    ev = dict(kw, if_training=False, rollout_test=2, iLow=2, iHigh=6)
    with precision("highest"):
        jax_run_training(if_aux=True, run_dir=str(out / "j"), **ev)
        got = run_training(if_aux=True, run_dir=str(out / "tj"), device="cpu", **ev)
    pj, pt = (pickle.loads((out / w / "DR_ds4_FNO.pickle").read_bytes()) for w in ("j", "tj"))
    assert len(pt) == 6 and all(type(v) is np.float64 for v in pt)
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    assert got.best_val == pt[1]
    mj, mt = (np.load(out / w / "DR_ds4_FNO_mse_time.npz")["mse"] for w in ("j", "tj"))
    np.testing.assert_allclose(mt, mj, rtol=1e-4)


def test_cli_aux_then_eval_then_collect(folder, tmp_path):
    """The port's own flow: ``aux`` trains, ``aux if_training=False`` writes
    the pickle and npz, ``collect`` reads them."""
    from sciml_pde_torch.eval.analyse import collect
    from sciml_pde_torch.train import cli

    args = ["--config", "config_dr", "--dataset", "basic_ds4", f"base_path={folder}/",
            f"aux_path={folder}/", f"run_dir={tmp_path}", "model_name=DR_ds4_FNO",
            "epochs=1", "width=8", "modes=4", "initial_step=4", "log_every=0", "device=cpu"]
    res = cli.main_aux(args)
    assert np.isfinite(res.best_val)
    assert sorted(restore_checkpoint(tmp_path / "DR_ds4_FNO_ckpt")["params"]) == [
        "backbone", "fc2_auxiliary", "fc2_primary"]
    ev = cli.main_aux(args + ["if_training=False", "rollout_test=2", "iLow=2", "iHigh=6"])
    assert np.isfinite(ev.best_val)
    assert np.load(tmp_path / "DR_ds4_FNO_mse_time.npz")["mse"].shape == (2,)
    df = collect(tmp_path)
    assert list(df.index) == [("DR", "ds4", "FNO")]
    np.testing.assert_allclose(df["nRMSE"].iloc[0], ev.best_val, rtol=1e-12)
    assert cli._SUBCOMMANDS["aux"] is cli.main_aux
