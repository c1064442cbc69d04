"""Port of the transformer trainer's aux joint training
(``run_transformer_training(if_aux=True)``, SWA, early-window sampling, the
signature and the CLI's keys) vs the JAX package, at img 32, patch 8,
tubelet 2, 4 frames: 32 tokens, the fused attention path (JAX's Pallas
kernels in interpret mode, the port's plain versions).  The model and the
step are in test_torch_transformer_aux.py.

Trained runs as in test_torch_transformer_train.py::test_one_epoch_matches_jax:
losses rtol 1e-4, parameters rtol 1e-3 / atol 1e-6."""

import inspect

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data.windows import weighted_epoch_batches as jax_weighted_epoch_batches
from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import transformer as jt
from sciml_pde_tpu.train import transformer_train as jtt
from sciml_pde_torch.data.windows import weighted_epoch_batches
from sciml_pde_torch.train import transformer_train as ttt
from sciml_pde_torch.utils.checkpoint import restore_checkpoint

from _torch_parity import assert_trees_close, to_numpy_tree

CFG = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, num_frames=4,
           encoder_dim=32, encoder_depth=2, encoder_heads=2, decoder_dim=16,
           decoder_depth=1, decoder_heads=1)
TRAIN_TOL = dict(rtol=1e-3, atol=1e-6)

# ---------------------------------------------------------------------------
# the trainer: NS aux with separate heads, DR aux with a shared head and SWA
# ---------------------------------------------------------------------------

S, T, NA = 2, 20, 2


def _write_ns(path, x, seed):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["velocity"] = rng.normal(size=(S, T, x, x, 2)).astype(np.float32)
        f["particles"] = rng.uniform(size=(S, T, x, x, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def ns_folder(tmp_path_factory):
    """Primary files 0 and 250 (test) at 32^2, aux files 0-1 at 16^2."""
    d = tmp_path_factory.mktemp("ns_aux_transformer")
    for i in (0, 250):
        _write_ns(d / f"ns_incom_inhom_2d_256-{i}.h5", 32, i)
    for i in range(NA):
        _write_ns(d / f"ns_aux_2d_256-{i}.h5", 16, 100 + i)
    return str(d)


TINY = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, encoder_embed_dim=32,
            encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=1, initial_step=4, batch_size=8, bf16=False, log_every=0,
            seed=5)


def _jax_init(shared: bool, in_chans: int, img: int, seed: int) -> dict:
    model = jt.VideoMAEOperatorAux(**dict(CFG, in_chans=in_chans, img_size=img),
                                   shared_head=shared)
    x0 = jnp.zeros((1, 4, img, img, in_chans))
    return to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(seed), x0, x0)["params"])


def _assert_runs_match(got, want):
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hg[key], hw[key], rtol=1e-4, err_msg=key)
    assert_trees_close(got.params, to_numpy_tree(want.params), what="trained params",
                       **TRAIN_TOL)


def test_ns_aux_epoch_matches_jax(ns_folder, tmp_path):
    """One NS aux epoch (separate heads, aux store at 16^2 kept at its
    resolution and upsampled in the step, grad_accum 2): 32 windows, four
    micro-steps of 8 primary + 16 aux windows; the best-primary-val
    checkpoint."""
    common = dict(base_path=ns_folder, aux_path=ns_folder, dataset_family="ns", if_aux=True,
                  train_subsample=(1, 1, NA), num_aux_samples=NA, test_range=(250, 251),
                  aux_upsample_at_gather=True, grad_accum=2, warmup_steps=1, epochs=1, **TINY)
    want = jtt.run_transformer_training(run_dir=str(tmp_path / "j"), model_name="j", **common)
    got = ttt.run_transformer_training(run_dir=str(tmp_path / "t"), model_name="t",
                                       init_params=_jax_init(False, 3, 32, 5), device="cpu",
                                       **common)
    _assert_runs_match(got, want)
    assert got.swa_params is None and want.swa_params is None
    ck = restore_checkpoint(tmp_path / "t" / "t_ckpt")
    assert ck["meta"]["loss"] == pytest.approx(got.best_val)
    assert tuple(ck["params"]["head_primary"]["kernel"].shape) == (3, 3)


def test_dr_aux_shared_head_swa_matches_jax(tmp_path):
    """DR aux with aux_shared_head (no heads) and swa_frac 0.5 over four
    epochs: the SWA window is the last two, at lr * swa_lr_factor, and
    swa_params is the mean of their weights, in both packages.  16^2,
    patch 4, tubelet 2, 4 frames: 32 tokens."""
    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, 16, dtype=np.float32)
    tgrid = np.linspace(0, 1, 12, dtype=np.float32)
    for s in range(10):
        write_seed_group(tmp_path / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(12, 16, 16, 2)).astype(np.float32), lin, lin, tgrid)
    for s in range(6):
        write_seed_group(tmp_path / "2D_diff-react_test_diff.h5", s,
                         rng.normal(size=(12, 16, 16, 2)).astype(np.float32), lin, lin, tgrid)
    common = dict(base_path=str(tmp_path) + "/", aux_path=str(tmp_path) + "/",
                  dataset_family="dr", if_aux=True, aux_shared_head=True, train_subsample=(4, 2, 6),
                  num_aux_samples=3, img_size=16, patch_size=4, tubelet_size=2, in_chans=2,
                  encoder_embed_dim=16, encoder_depth=1, encoder_num_heads=2,
                  decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2, initial_step=4,
                  batch_size=8, epochs=4, bf16=False, log_every=0, seed=2, loss_type="nrmse",
                  swa_frac=0.5, swa_lr_factor=0.5, learning_rate_share=3e-3)
    model = jt.VideoMAEOperatorAux(img_size=16, patch_size=4, tubelet_size=2, in_chans=2,
                                   num_frames=4, encoder_dim=16, encoder_depth=1,
                                   encoder_heads=2, decoder_dim=16, decoder_depth=1,
                                   decoder_heads=2, shared_head=True)
    x0 = jnp.zeros((1, 4, 16, 16, 2))
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(2), x0, x0)["params"])
    want = jtt.run_transformer_training(run_dir=str(tmp_path / "j"), model_name="j", **common)
    got = ttt.run_transformer_training(run_dir=str(tmp_path / "t"), model_name="t",
                                       init_params=init, device="cpu", **common)
    _assert_runs_match(got, want)
    assert "head_primary" not in got.params
    assert_trees_close(got.swa_params, to_numpy_tree(want.swa_params), what="swa_params",
                       **TRAIN_TOL)
    moved = max(np.abs(got.swa_params["head"]["kernel"] - got.params["head"]["kernel"]).max(),
                1e-30)
    assert moved > 1e-6, moved


def test_swa_schedule_matches_optax():
    """make_transformer_optimizer's schedule with an SWA start and warmup,
    against optax's join_schedules, through applied updates (the count
    MultiSteps keeps under accumulation)."""
    import optax

    rng = np.random.default_rng(3)
    tree = {"encoder": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}
    kw = dict(total_steps=8, warmup_steps=2, grad_accum=2, swa_start=5, swa_lr_factor=0.25)
    tx = jtt.make_transformer_optimizer(1e-2, 1e-2, **kw)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(p_j)
    p_t = {"encoder.w": torch.tensor(tree["encoder"]["w"])}
    opt = ttt.make_transformer_optimizer(p_t, 1e-2, 1e-2, **kw)
    for _ in range(16):
        g = rng.normal(size=(4, 3)).astype(np.float32)
        upd, state = tx.update({"encoder": {"w": jnp.asarray(g)}}, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        opt.step(p_t, {"encoder.w": torch.tensor(g)})
        np.testing.assert_allclose(p_t["encoder.w"].numpy(), np.asarray(p_j["encoder"]["w"]),
                                   rtol=1e-5, atol=1e-7)
    assert opt.count == 8 and opt.schedules["backbone"](5) == 1e-2 * 0.25


# ---------------------------------------------------------------------------
# early-window sampling
# ---------------------------------------------------------------------------


def test_weighted_epoch_batches_match_jax():
    index = np.stack([np.repeat(np.arange(3), 9), np.tile(np.arange(9), 3)], 1).astype(np.int32)
    w = 1.0 + 4.0 * (index[:, 1] <= 2)
    for seed in (0, 7):
        got = list(weighted_epoch_batches(index, 4, np.random.default_rng(seed), w))
        want = list(jax_weighted_epoch_batches(index, 4, np.random.default_rng(seed), w))
        assert len(got) == len(want) == 6
        for g, h in zip(got, want):
            np.testing.assert_array_equal(g, h)


def test_early_window_epoch_matches_jax(ns_folder, tmp_path, monkeypatch):
    """A baseline NS epoch with early_window_boost 4 (windows with t0 <= 3
    weighted 5; grad_accum 2, warmup 1): the batches the port trains on are
    JAX's draws, in order, and the run matches JAX's."""
    import sciml_pde_torch.train.transformer_train as mod

    common = dict(base_path=ns_folder, dataset_family="ns", if_aux=False,
                  train_subsample=(1, 1, 1), test_range=(250, 251), epochs=1, grad_accum=2,
                  warmup_steps=1, early_window_boost=4.0, early_window_t0=3, **TINY)
    model = jt.VideoMAEOperator(**CFG)
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(5),
                                             jnp.zeros((1, 4, 32, 32, 3)))["params"])
    seen = []
    real = mod.weighted_epoch_batches
    monkeypatch.setattr(mod, "weighted_epoch_batches",
                        lambda *a: [seen.append(b) or b for b in real(*a)])
    want = jtt.run_transformer_training(run_dir=str(tmp_path / "j"), model_name="j", **common)
    got = ttt.run_transformer_training(run_dir=str(tmp_path / "t"), model_name="t",
                                       init_params=init, device="cpu", **common)
    index = np.stack([np.repeat(np.arange(S), T - 4), np.tile(np.arange(T - 4), S)], 1)
    w = 1.0 + 4.0 * (index[:, 1] <= 3)
    expect = list(jax_weighted_epoch_batches(index, 8, np.random.default_rng(5), w))
    assert len(seen) == len(expect) == 4
    for g, h in zip(seen, expect):
        np.testing.assert_array_equal(g, h)
    assert np.mean(np.concatenate(seen)[:, 1] <= 3) > 0.4  # 4 of 16 t0s, weighted 5x
    _assert_runs_match(got, want)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_run_transformer_training_signature_is_jax():
    """Every keyword of JAX's run_transformer_training, in its order and with
    its defaults, then init_params and device."""
    got = inspect.signature(ttt.run_transformer_training).parameters
    want = inspect.signature(jtt.run_transformer_training).parameters
    assert list(got) == list(want) + ["init_params", "device"]
    for name, p in want.items():
        assert got[name].default == p.default, name


def test_cli_transformer_passes_aux_keys_like_jax(monkeypatch, tmp_path):
    """``transformer --config config_ns`` hands run_transformer_training the
    same keywords in both CLIs, the aux ones included (aux_path, aux_name,
    num_aux_samples, auxiliary_weight, if_downsample)."""
    import functools
    import types

    from sciml_pde_tpu.train import cli as jax_cli
    from sciml_pde_tpu.train import transformer_train as jax_mod
    from sciml_pde_torch.train import cli
    from sciml_pde_torch.train import transformer_train as mod

    def capture(module):
        seen, real = {}, module.run_transformer_training

        @functools.wraps(real)
        def fake(**kw):
            seen.update(kw)
            return types.SimpleNamespace(best_val=0.0, history=[])

        monkeypatch.setattr(module, "run_transformer_training", fake)
        return seen

    want, got = capture(jax_mod), capture(mod)
    args = ["--config", "config_ns", f"base_path={tmp_path}", f"aux_path={tmp_path}/aux",
            "num_aux_samples=3", "aux_shared_head=True", "swa_frac=0.5"]
    jax_cli.main_transformer(args)
    cli.main_transformer(args + ["device=cpu"])
    assert got.pop("device") == "cpu"
    assert got == want
    for key in ("aux_path", "aux_name", "num_aux_samples", "auxiliary_weight",
                "if_downsample", "aux_shared_head", "swa_frac"):
        assert key in got, key
