"""Port train/fno_train.py vs JAX run_training on both steps (fused and
production), from the same initial weights and the same batch order, and
the step selection and refusals of the port's trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.io.h5 import write_seed_group
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.train.fno_train import run_training as jax_run_training
from sciml_pde_torch.train.fno_train import default_init_tree, run_training, select_fast_step
from sciml_pde_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from _torch_parity import assert_trees_close, precision, to_numpy_tree

S, X, C = 12, 16, 2
COMMON = dict(if_aux=False, train_subsample=(4, 2, 6), modes=4, width=8, initial_step=5,
              rollout_test=1, num_channels=C, batch_size=4, epochs=1, learning_rate=2e-3,
              log_every=0, seed=3)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("dr_train")
    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, X, dtype=np.float32)
    for s in range(10):
        write_seed_group(d / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(S, X, X, C)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, S, dtype=np.float32))
    return str(d) + "/"


def _jax_init():
    # the JAX trainer initialises from PRNGKey(seed) at these shapes
    return to_numpy_tree(FlaxFNO2d(num_channels=C, modes1=4, modes2=4, width=8,
                                   initial_step=5).init(
        jax.random.PRNGKey(COMMON["seed"]), jnp.zeros((1, X, X, 5, C)),
        jnp.zeros((1, X, X, 2)))["params"])


def test_one_epoch_matches_jax_fast_step(folder, tmp_path):
    init = _jax_init()
    with precision("highest"):
        want = jax_run_training(base_path=folder, fast_step=True, run_dir=str(tmp_path / "j"),
                                model_name="j", **COMMON)
        got = run_training(base_path=folder, run_dir=str(tmp_path / "t"), model_name="t",
                           init_params=init, device="cpu", fast_step=True,
                           **{k: v for k, v in COMMON.items() if k != "if_aux"})
    assert len(got.history) == len(want.history) == 1
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-3)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-3)
    assert_trees_close(got.params, to_numpy_tree(want.params), rtol=5e-3, atol=1e-5,
                       what="trained params")

    ck = restore_checkpoint(tmp_path / "t" / "t_ckpt")
    assert ck["meta"]["epoch"] == 0
    assert ck["params"]["backbone"]["conv0"]["w1"].shape == (2, 8, 8, 4, 4)
    assert ck["params"]["fc2"]["Dense_0"]["kernel"].shape == (128, C)


def test_continue_training_resumes_from_checkpoint(folder, tmp_path):
    kw = {k: v for k, v in COMMON.items() if k != "if_aux"}
    run_training(base_path=folder, run_dir=str(tmp_path), model_name="r", device="cpu", **kw)
    kw["epochs"] = 2
    res = run_training(base_path=folder, run_dir=str(tmp_path), model_name="r",
                       device="cpu", continue_training=True, **kw)
    # the JAX trainer resumes at the checkpoint's (best) epoch
    assert [h["epoch"] for h in res.history] == [0, 1]
    assert all(np.isfinite(h["val_loss"]) for h in res.history)
    assert restore_checkpoint(tmp_path / "r_ckpt")["opt_state"][2]["count"] > 0  # optax adam


@pytest.mark.parametrize("bad", [dict(if_aux=True), dict(training_type="autoregressive"),
                                 dict(rollout_test=2), dict(scheduler="step")])
def test_unsupported_configs_raise(tmp_path, bad):
    """An explicit fast_step=True on a configuration the fused step does not
    run raises before any data is read, with the JAX trainer's words."""
    with pytest.raises(ValueError) as want:
        jax_run_training(base_path=str(tmp_path), run_dir=str(tmp_path), fast_step=True, **bad)
    with pytest.raises(ValueError, match="fast_step=True requires the plain 2D FNO") as got:
        run_training(base_path=str(tmp_path), device="cpu", fast_step=True, **bad)
    assert str(got.value) == str(want.value)


PRODUCTION = {
    "cosine": dict(),
    "autoregressive": dict(training_type="autoregressive", t_train=9),
    "steplr": dict(scheduler="step", scheduler_step=3, scheduler_gamma=0.5),
}


@pytest.mark.parametrize("case", PRODUCTION.values(), ids=PRODUCTION.keys())
def test_two_epochs_match_jax_production_step(folder, tmp_path, case):
    """The default (production) step for two epochs against JAX's
    run_training(fast_step=False) from the same tree: train and val loss
    per epoch within rtol 1e-4.  The autoregressive case gathers 4 target
    frames from windows indexed for one, so windows run past the end of
    their 12-frame trajectories and the gather clamps."""
    kw = dict(COMMON, epochs=2, learning_rate=1e-3, **case)
    with precision("highest"):
        want = jax_run_training(base_path=folder, fast_step=False, run_dir=str(tmp_path / "j"),
                                model_name="j", **kw)
        kw.pop("if_aux")
        got = run_training(base_path=folder, run_dir=str(tmp_path / "t"), model_name="t",
                           init_params=_jax_init(), device="cpu", **kw)
    assert [h["epoch"] for h in got.history] == [h["epoch"] for h in want.history] == [0, 1]
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
    ck = restore_checkpoint(tmp_path / "t" / "t_ckpt")
    adam = ck["opt_state"][2]  # optax's (clip, L2, adam, schedule) chain
    assert isinstance(adam["mu"], dict) and adam["count"] > 0
    assert ck["params"]["backbone"]["conv0"]["w1"].shape == (2, 8, 8, 4, 4)


def test_cli_train_matches_jax_cli(folder, tmp_path, monkeypatch):
    """``train`` with no fast_step key runs the production step in both CLIs:
    two epochs from the same tree (the port's seeded init replaced by the
    JAX one) give the same history within rtol 1e-4."""
    from sciml_pde_tpu.train.cli import main as jax_main
    from sciml_pde_torch.train import cli, fno_train

    monkeypatch.delenv("SCIML_FAST_STEP", raising=False)
    monkeypatch.setattr(fno_train, "default_init_tree", lambda *a, **k: _jax_init())
    args = ["--config", "config_dr", "--dataset", "basic_ds4", f"base_path={folder}",
            "epochs=2", "width=8", "modes=4", "initial_step=5", "seed=3", "log_every=0"]
    with precision("highest"):
        want = jax_main(args + [f"run_dir={tmp_path / 'j'}"])
        got = cli.main(args + [f"run_dir={tmp_path / 't'}", "device=cpu"])
    assert len(got.history) == len(want.history) == 2
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
    assert isinstance(restore_checkpoint(tmp_path / "t" / "FNO_ckpt")["opt_state"][2]["mu"], dict)


@pytest.mark.parametrize("env, config, fused", [
    ("1", {}, True), ("", {}, False), ("true", dict(training_type="autoregressive"), False),
    ("1", dict(scheduler="step"), False),
])
def test_fast_step_none_follows_env(folder, tmp_path, monkeypatch, env, config, fused):
    """fast_step=None reads SCIML_FAST_STEP; on a configuration the fused step
    does not run the variable gives way to the production step."""
    monkeypatch.setenv("SCIML_FAST_STEP", env)
    assert select_fast_step(None, **config) is fused
    kw = {k: v for k, v in COMMON.items() if k != "if_aux"}
    run_training(base_path=folder, run_dir=str(tmp_path), model_name="e", device="cpu",
                 **dict(kw, **config))
    ost = restore_checkpoint(tmp_path / "e_ckpt")["opt_state"]
    assert isinstance(ost, dict) and isinstance(ost["m"], torch.Tensor) is fused or (
        not fused and isinstance(ost[2]["mu"], dict))  # FlatOptState, or optax's adam


def test_resume_needs_the_same_step(folder, tmp_path):
    kw = {k: v for k, v in COMMON.items() if k != "if_aux"}
    run_training(base_path=folder, run_dir=str(tmp_path), model_name="r", device="cpu",
                 fast_step=False, **kw)
    with pytest.raises(ValueError, match="fast_step"):
        run_training(base_path=folder, run_dir=str(tmp_path), model_name="r", device="cpu",
                     fast_step=True, continue_training=True, **dict(kw, epochs=2))


@pytest.mark.parametrize("if_aux", [False, True], ids=["baseline", "aux"])
def test_evaluation_plot_writes_the_field_render(folder, tmp_path, if_aux):
    """``if_training=False, plot=True`` writes ``{model_name}_pred.png``
    beside the pickle, for a baseline and a two-head checkpoint."""
    tree = default_init_tree(C, 4, 8, 5, seed=0, aux=if_aux)
    save_checkpoint(tmp_path / "p_ckpt", tree, {}, 0, 0.0)
    res = run_training(base_path=folder, run_dir=str(tmp_path), model_name="p", device="cpu",
                       if_training=False, if_aux=if_aux, plot=True, channel_plot=1,
                       modes=4, width=8, initial_step=5, rollout_test=2)
    png = tmp_path / "p_pred.png"
    assert png.exists() and png.stat().st_size > 0 and (tmp_path / "p.pickle").exists()
    assert np.isfinite(res.best_val)


GUARDS = {
    "rotate_and_stream": dict(resident_rotate=2, host_stream=True),
    "rotate_and_shard": dict(resident_rotate=2, shard_store=True),
    "interleave_too_short": dict(resident_rotate=2, resident_rotate_schedule="interleave",
                                 epochs=3),
    "stream_and_shard": dict(host_stream=True, shard_store=True),
    "stream_and_aux_chunks": dict(if_aux=True, host_stream=True, aux_chunks=2),
    "stream_and_upsample_in_step": dict(if_aux=True, host_stream=True,
                                        aux_upsample_at_gather=True),
    "fast_step_and_stream": dict(fast_step=True, host_stream=True),
    "rotation_not_dividing_the_pool": dict(resident_rotate=3),
    "shard_not_dividing_the_batch": dict(shard_store=True, batch_size=3),
    "model_axis": None,
}


@pytest.mark.parametrize("option", GUARDS.values(), ids=GUARDS.keys())
def test_out_of_scope_options_raise(folder, tmp_path, monkeypatch, option):
    """Each of JAX's refusals of the placement options raises in the port
    with JAX's exception type and words, on the same files (the sharded
    case on a data axis of two in both packages); a mesh with a model axis
    of two on one rank raises what JAX's raises on one device."""
    import sciml_pde_tpu.train.fno_train as jft
    from sciml_pde_tpu.parallel import make_mesh as jax_make_mesh
    from sciml_pde_torch import parallel
    from sciml_pde_torch.train import fno_train

    if option is None:
        with pytest.raises(ValueError) as want:
            jax_make_mesh(model=2, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            parallel.make_mesh(model=2)
        assert str(got.value) == str(want.value) == "1 devices not divisible by model=2"
        return
    if option.get("shard_store") and "batch_size" in option:
        monkeypatch.setattr(jft, "make_mesh", lambda: jax_make_mesh(devices=jax.devices()[:2]))
        monkeypatch.setattr(fno_train, "make_mesh", lambda: parallel.Mesh((0, 1), 2))
    kw = dict(COMMON, **option)
    with pytest.raises(Exception) as want:
        jax_run_training(base_path=folder, run_dir=str(tmp_path / "j"), model_name="g", **kw)
    with pytest.raises(type(want.value)) as got:
        run_training(base_path=folder, run_dir=str(tmp_path / "t"), model_name="g",
                     device="cpu", **kw)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def _capture_run_training(monkeypatch, module):
    """Replace ``module.run_training`` with a stand-in of the same signature
    that records its keyword arguments."""
    import functools
    import types

    seen = {}
    real = module.run_training

    @functools.wraps(real)
    def fake(**kw):
        seen.update(kw)
        return types.SimpleNamespace(best_val=0.0, history=[])

    monkeypatch.setattr(module, "run_training", fake)
    return seen


def test_cli_train_forces_the_baseline_like_jax(monkeypatch, tmp_path):
    """``train if_aux=True`` reaches run_training with if_aux=False in both
    CLIs: the subcommand is the baseline whatever the config says."""
    from sciml_pde_tpu.train import cli as jax_cli
    from sciml_pde_tpu.train import fno_train as jax_fno_train
    from sciml_pde_torch.train import cli, fno_train

    want = _capture_run_training(monkeypatch, jax_fno_train)
    got = _capture_run_training(monkeypatch, fno_train)
    args = ["--config", "config_dr", "--dataset", "basic_ds4", f"base_path={tmp_path}",
            "if_aux=True"]
    jax_cli.main(args)
    cli.main(args + ["device=cpu"])
    assert want["if_aux"] is False and got["if_aux"] is False


def test_metric_log_matches_jax(folder, tmp_path):
    """Two epochs of the production step write ``{run_dir}/{model_name}.jsonl``
    in both packages: the same records (keys and steps) in the same order,
    the training scalars when log_every crosses and val_loss on every epoch;
    losses within the histories' rtol 1e-4, grad norms within 1e-3."""
    import json

    kw = dict(COMMON, epochs=2, learning_rate=1e-3, log_every=5)
    with precision("highest"):
        jax_run_training(base_path=folder, fast_step=False, run_dir=str(tmp_path / "j"),
                         model_name="m", **kw)
        kw.pop("if_aux")
        run_training(base_path=folder, run_dir=str(tmp_path / "t"), model_name="m",
                     init_params=_jax_init(), device="cpu", **kw)

    def records(d):
        return [json.loads(line) for line in (tmp_path / d / "m.jsonl").read_text().splitlines()]

    got, want = records("t"), records("j")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [7, 7, 14, 14]
    assert sum("val_loss" in r for r in got) == 2
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for key, rtol in (("train_loss", 1e-4), ("val_loss", 1e-4), ("grad_norm", 1e-3)):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=key)
