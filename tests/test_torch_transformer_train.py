"""Port train/optim.py and train/transformer_train.py vs the JAX package: the
optimizer chain against optax, the losses, the NS loader, and one tiny NS
epoch of run_transformer_training from the same initial weights and the
same batch order."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_tpu.data.ns import load_ns_baseline as jax_load_ns_baseline
from sciml_pde_tpu.models.transformer import VideoMAEOperator as FlaxVideoMAE
from sciml_pde_tpu.train import transformer_train as jtt
from sciml_pde_tpu.train.optim import make_lr_schedule as jax_make_lr_schedule
from sciml_pde_torch.data.ns import load_ns_baseline
from sciml_pde_torch.train import transformer_train as ttt
from sciml_pde_torch.train.cli import main_transformer
from sciml_pde_torch.train.optim import make_lr_schedule, with_warmup
from sciml_pde_torch.utils.checkpoint import restore_checkpoint

from _torch_parity import assert_trees_close, to_numpy_tree

# img 32, patch 8, tubelet 2, 4 frames -> 32 tokens: the fused (Pallas /
# plain-version) attention path
S, X, T = 2, 32, 20
TINY = dict(img_size=X, patch_size=8, tubelet_size=2, in_chans=3, encoder_embed_dim=32,
            encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=1, initial_step=4, batch_size=8, epochs=1, bf16=False,
            log_every=0, seed=5)


def _write_ns(path, seed):
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["velocity"] = rng.normal(size=(S, T, X, X, 2)).astype(np.float32)
        f["particles"] = rng.uniform(size=(S, T, X, X, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def ns_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("ns_transformer")
    for i in (0, 250):
        _write_ns(d / f"ns_incom_inhom_2d_256-{i}.h5", i)
    return str(d)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["cosine", "step"])
def test_schedules_match_optax(scheduler):
    want = jax_make_lr_schedule(scheduler, 1e-3, 7, scheduler_step=3, scheduler_gamma=0.5)
    got = make_lr_schedule(scheduler, 1e-3, 7, scheduler_step=3, scheduler_gamma=0.5)
    warm_want = optax.join_schedules([optax.linear_schedule(0.0, 1e-3, 4), want], [4])
    warm_got = with_warmup(got, 1e-3, 4)
    for c in range(12):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6)
        np.testing.assert_allclose(warm_got(c), float(warm_want(c)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scheduler", ["cosine", "step"])
def test_optimizer_matches_optax(scheduler):
    """Two groups, clip active, warmup and grad_accum=2: parameters after
    every micro-step within f32 rounding of optax (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    tree = {"encoder": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "head_primary": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}}
    tx = jtt.make_transformer_optimizer(1e-2, 3e-2, total_steps=5, scheduler=scheduler,
                                        clip=0.5, warmup_steps=2, grad_accum=2,
                                        scheduler_step=2)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params_j)
    params_t = {"encoder.w": torch.tensor(tree["encoder"]["w"]),
                "head_primary.kernel": torch.tensor(tree["head_primary"]["kernel"])}
    opt = ttt.make_transformer_optimizer(params_t, 1e-2, 3e-2, total_steps=5,
                                         scheduler=scheduler, clip=0.5, warmup_steps=2,
                                         grad_accum=2, scheduler_step=2)
    assert opt.groups == {"backbone": ["encoder.w"], "heads": ["head_primary.kernel"]}
    for i in range(10):
        g = {"encoder": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
             "head_primary": {"kernel": 3 * rng.normal(size=(3, 2)).astype(np.float32)}}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        applied = opt.step(params_t, {"encoder.w": torch.tensor(g["encoder"]["w"]),
                                      "head_primary.kernel":
                                          torch.tensor(g["head_primary"]["kernel"])})
        assert applied == (i % 2 == 1)
        np.testing.assert_allclose(params_t["encoder.w"].numpy(),
                                   np.asarray(params_j["encoder"]["w"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(params_t["head_primary.kernel"].numpy(),
                                   np.asarray(params_j["head_primary"]["kernel"]),
                                   rtol=1e-5, atol=1e-7)
    assert opt.count == 5


def test_optimizer_state_round_trip():
    p = {"a": torch.ones(3)}
    opt = ttt.make_transformer_optimizer(p, 1e-3, 1e-3, total_steps=4, grad_accum=2)
    opt.step(p, {"a": torch.full((3,), 2.0)})
    other = ttt.make_transformer_optimizer({"a": torch.ones(3)}, 1e-3, 1e-3, total_steps=4,
                                           grad_accum=2)
    other.load_state_dict(opt.state_dict())
    assert other.mini_step == 1 and torch.equal(other.acc["a"], opt.acc["a"])


# ---------------------------------------------------------------------------
# losses and the NS loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type,fourier_weight", [("nrmse2", 0.0), ("nrmse", 0.0),
                                                      ("nrmse_perchannel", 0.0),
                                                      ("nrmse", 0.1)])
def test_losses_match_jax(loss_type, fourier_weight):
    rng = np.random.default_rng(1)
    y = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    p = y + 0.1 * rng.normal(size=y.shape).astype(np.float32)
    want = float(jtt._make_loss(loss_type, fourier_weight)(jnp.asarray(p), jnp.asarray(y)))
    got = float(ttt._make_loss(loss_type, fourier_weight)(torch.tensor(p), torch.tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("subsample", [1, 0.5])
def test_ns_loader_matches_jax(ns_folder, subsample):
    kw = dict(train_subsample=subsample, initial_step=4, rollout_test=1,
              test_range=(250, 251))
    want = jax_load_ns_baseline(ns_folder, **kw)
    got = load_ns_baseline(ns_folder, device="cpu", **kw)
    for g, w in ((got.train, want.train), (got.test, want.test)):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.window_index(), w.window_index())


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_one_epoch_matches_jax(ns_folder, tmp_path):
    """f32, batch 8 (the JAX trainer shards it over the 8-device CPU mesh),
    grad_accum 2, warmup 1: 32 windows give four micro-steps and two
    updates, the first at learning rate 0.  Losses within rtol 1e-4, trained
    parameters within rtol 1e-3 / atol 1e-6 (f32 sums in another order)."""
    common = dict(dataset_family="ns", if_aux=False, train_subsample=(1, 1, 1),
                  test_range=(250, 251), grad_accum=2, warmup_steps=1, **TINY)
    model = FlaxVideoMAE(img_size=X, patch_size=8, tubelet_size=2, in_chans=3,
                         num_frames=4, encoder_dim=32, encoder_depth=2, encoder_heads=2,
                         decoder_dim=16, decoder_depth=1, decoder_heads=1)
    x0 = jax_load_ns_baseline(ns_folder, train_subsample=1, initial_step=4,
                              test_range=(250, 251)).train.data[:1, :4]
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(TINY["seed"]), x0)["params"])
    want = jtt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "j"),
                                        model_name="j", **common)
    got = ttt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "t"),
                                       model_name="t", init_params=init, device="cpu",
                                       **common)
    assert len(got.history) == len(want.history) == 1
    np.testing.assert_allclose(got.history[0]["train_loss"], want.history[0]["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got.history[0]["val_loss"], want.history[0]["val_loss"],
                               rtol=1e-4)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=1e-3, atol=1e-6,
                       what="trained params")
    moved = np.abs(got.params["head"]["kernel"] - init["head"]["kernel"]).max()
    assert moved > 1e-4, moved
    ck = restore_checkpoint(tmp_path / "t" / "t_ckpt")
    assert ck["meta"]["epoch"] == 0
    assert tuple(ck["params"]["encoder"]["block0"]["attn"]["qkv_kernel"].shape) == (32, 96)


def test_cli_transformer_resumes_on_cpu(ns_folder, tmp_path):
    args = ["--config", "config_ns", f"base_path={ns_folder}", "if_aux=False",
            "test_range=(250, 251)", "train_subsample=[1, 1, 1]", "initial_step=4",
            "img_size=32", "patch_size=8", "encoder_embed_dim=16", "encoder_depth=1",
            "encoder_num_heads=1", "decoder_embed_dim=16", "decoder_depth=1",
            "decoder_num_heads=1", "batch_size=8", "log_every=0", "device=cpu",
            f"run_dir={tmp_path}", "model_name=NS_cli_VMAE"]
    first = main_transformer(args + ["epochs=1"])
    res = main_transformer(args + ["epochs=2", "continue_training=True"])
    assert np.isfinite(first.best_val)
    assert [h["epoch"] for h in res.history] == [0, 1]
    ost = restore_checkpoint(tmp_path / "NS_cli_VMAE_ckpt")["opt_state"]  # optax partition
    assert ost[1]["inner_states"]["backbone"]["inner_state"][1]["count"] > 0


@pytest.mark.parametrize("bad", [dict(resident_rotate=2, host_stream=True),
                                 dict(host_stream=True, early_window_boost=4.0),
                                 dict(resident_rotate=3)],
                         ids=["rotate_and_stream", "stream_and_early_windows",
                              "rotation_not_dividing_the_pool"])
def test_unported_options_raise(ns_folder, tmp_path, bad):
    """JAX's refusals of the placement options raise in the port with JAX's
    exception type and words, on the same files."""
    kw = dict(TINY, dataset_family="ns", if_aux=False, train_subsample=(1, 1, 1),
              test_range=(250, 251), **bad)
    with pytest.raises(Exception) as want:
        jtt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "j"), **kw)
    with pytest.raises(type(want.value)) as got:
        ttt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "t"),
                                     device="cpu", **kw)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_metric_log_matches_jax(ns_folder, tmp_path):
    """One tiny NS epoch with log_every=1 writes ``{run_dir}/{model_name}.jsonl``
    in both packages: the same records (keys and steps), the training
    scalars and val_loss; losses within rtol 1e-4, grad norms within 1e-3."""
    import json

    common = dict(dataset_family="ns", if_aux=False, train_subsample=(1, 1, 1),
                  test_range=(250, 251), grad_accum=2, warmup_steps=1,
                  **dict(TINY, log_every=1))
    model = FlaxVideoMAE(img_size=X, patch_size=8, tubelet_size=2, in_chans=3,
                         num_frames=4, encoder_dim=32, encoder_depth=2, encoder_heads=2,
                         decoder_dim=16, decoder_depth=1, decoder_heads=1)
    x0 = jax_load_ns_baseline(ns_folder, train_subsample=1, initial_step=4,
                              test_range=(250, 251)).train.data[:1, :4]
    init = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(TINY["seed"]), x0)["params"])
    jtt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "j"),
                                 model_name="m", **common)
    ttt.run_transformer_training(base_path=ns_folder, run_dir=str(tmp_path / "t"),
                                 model_name="m", init_params=init, device="cpu", **common)

    def records(d):
        return [json.loads(line) for line in (tmp_path / d / "m.jsonl").read_text().splitlines()]

    got, want = records("t"), records("j")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [4, 4]
    assert "train_loss" in got[0] and "val_loss" in got[1]
    for g, w in zip(got, want):
        for key, rtol in (("train_loss", 1e-4), ("val_loss", 1e-4), ("grad_norm", 1e-3)):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=key)
