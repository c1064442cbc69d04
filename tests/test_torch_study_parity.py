"""The port's study drivers against the JAX package's drivers of the same
names (``experiments/``), on the CPU from the same seeded inputs and one
flax tree (saved through each package's checkpoint writer):

  - the DR VideoMAE's evaluation (``dr_transformer --eval-only``), the
    convention rows and the v-channel table: f32 within 1e-5, bf16 within
    3e-2 (the drivers' bf16 inference sums bf16 products in other orders);
  - three steps of the early-window fine-tune (optax's chain against the
    port's AdamW with clip and cosine schedule): each step's loss, the
    weights after, the tables after and the epoch's mean loss within 1e-5;
  - the data audit at 16^2, ``scipy_traj``, ``persistence_nrmse`` and the
    family audit at a reduced config, ``collect`` and the seed figure's
    aggregate, the gate's degradation and verdict on fixed rollout tables,
    ``build_toy_folder``'s files (h5py and the port's own HDF5 subset), and
    the round figures' panels."""

import functools
import importlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dr_files import write_dr128
from _torch_parity import assert_trees_close, few_threads, to_numpy_tree  # noqa: F401

WIDTHS = dict(encoder_dim=16, encoder_depth=1, encoder_heads=2, decoder_dim=16,
              decoder_depth=1, decoder_heads=2)
TINY = [a for k, v in WIDTHS.items() for a in (f"--{k.replace('_', '-')}", str(v))]
CPU = ["--device", "cpu"]


def jax_driver(name: str):
    return importlib.import_module(f"experiments.{name}")


def port_driver(name: str):
    return importlib.import_module(f"sciml_pde_torch.experiments.{name}")


@pytest.fixture(scope="module")
def dr(tmp_path_factory):
    """The 128^2 DR files and one flax VideoMAE tree at the tiny widths,
    saved as a JAX (orbax) and a port (.pt) checkpoint with best-val 0.5."""
    import jax
    import jax.numpy as jnp

    from sciml_pde_tpu.models.transformer import VideoMAEOperator
    from sciml_pde_tpu.utils.checkpoint import save_checkpoint as jax_save
    from sciml_pde_torch.utils.checkpoint import save_checkpoint as port_save

    root = tmp_path_factory.mktemp("study")
    data = write_dr128(root)
    model = VideoMAEOperator(img_size=128, patch_size=16, tubelet_size=1, in_chans=2,
                             num_frames=10, **WIDTHS)
    tree = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(3),
                                             jnp.zeros((1, 10, 128, 128, 2)))["params"])
    jax_save(root / "jax_ckpt", tree, {}, 0, 0.5)
    port_save(root / "port_ckpt", tree, {}, 0, 0.5)
    return types.SimpleNamespace(root=root, data=data, tree=tree, jax_ckpt=root / "jax_ckpt",
                                 port_ckpt=root / "port_ckpt")


def assert_nested_close(got, want, rtol, atol=0.0, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_nested_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif isinstance(want, list) and want and isinstance(want[0], (list, dict)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_nested_close(g, w, rtol, atol, f"{path}/{i}")
    elif isinstance(want, (float, list)) and want is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)
    else:
        assert got == want, path


def test_dr_transformer_eval_matches_jax(dr, tmp_path):
    """--eval-only from one tree, both variants (the aux model's shared head
    adds no parameters), f32: the rollout tables within 1e-5."""
    import shutil

    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    for v in ("baseline", "aux"):
        shutil.copytree(dr.jax_ckpt, tmp_path / "j" / f"vmae_dr_basic_ds2_{v}_ckpt")
        shutil.copytree(dr.port_ckpt, tmp_path / "t" / f"vmae_dr_basic_ds2_{v}_ckpt")
    common = ["--data", dr.data, "--dataset", "basic_ds2", "--eval-only", "--precision", "fp32",
              *TINY]
    jax_driver("dr_transformer").main(common + ["--out", str(tmp_path / "j")])
    got = port_driver("dr_transformer").main(common + ["--out", str(tmp_path / "t"), *CPU])
    want = json.loads((tmp_path / "j" / "summary.json").read_text())
    assert_nested_close(json.loads(json.dumps(got)), want, rtol=1e-5)


def _jax_roll(tree, test, t0: int, steps: int, dtype):
    """The JAX drivers' scanned rollout, (steps, N, H, W, C)."""
    import jax
    import jax.numpy as jnp

    from sciml_pde_tpu.models.transformer import VideoMAEOperator

    model = VideoMAEOperator(img_size=128, patch_size=16, tubelet_size=1, in_chans=2,
                             num_frames=10, dtype=dtype, **WIDTHS)

    def body(xx, _):
        pred = model.apply({"params": tree}, xx)
        return jnp.concatenate([xx[:, 1:], pred[:, None]], axis=1), pred

    return jax.jit(lambda x0: jax.lax.scan(body, x0, None, length=steps)[1])(
        jnp.asarray(test[:, t0:t0 + 10]))


def test_convention_rows_match_jax_in_f32(dr):
    """JAX's driver infers in bf16 only; its row functions on its f32
    rollout against the port's ``convention_rows`` on an f32 model."""
    import jax.numpy as jnp

    jce, tce = jax_driver("dr_convention_eval"), port_driver("dr_convention_eval")
    from sciml_pde_torch.experiments import _dr_vmae

    test = _dr_vmae.load_test(dr.data)
    preds = _jax_roll(dr.tree, test, 0, 3, jnp.float32)
    tgts = [jnp.asarray(test[:, 10 + k]) for k in range(3)]
    want = {"joint_final": [jce.joint_nrmse(preds[k], tgts[k]) for k in range(3)],
            "perch_final": [jce.perch_nrmse(preds[k], tgts[k]) for k in range(3)],
            "joint_all": [jce.joint_nrmse(jnp.concatenate(list(preds[:k + 1])),
                                          jnp.concatenate(tgts[:k + 1])) for k in range(3)],
            "perch_all": [jce.perch_nrmse(jnp.concatenate(list(preds[:k + 1])),
                                          jnp.concatenate(tgts[:k + 1])) for k in range(3)]}
    args = types.SimpleNamespace(**WIDTHS)
    got = tce.convention_rows(_dr_vmae.build(args, torch.float32, dr.tree), test, 0, 3)
    assert_nested_close(got, want, rtol=1e-5)


def test_convention_eval_main_matches_jax_in_bf16(dr, tmp_path):
    args = ["--data", dr.data, "--rollout", "3", *TINY]
    jax_driver("dr_convention_eval").main(args + ["--ckpts", f"baseline={dr.jax_ckpt}",
                                                  "--out", str(tmp_path / "j.json")])
    got = port_driver("dr_convention_eval").main(
        args + ["--ckpts", f"baseline={dr.port_ckpt}", "--out", str(tmp_path / "t.json"), *CPU])
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(json.dumps(got))
    assert_nested_close(got, want, rtol=3e-2)


@pytest.fixture(scope="module")
def vchannel(dr):
    out = dr.root / "vc"
    out.mkdir()
    args = ["--data", dr.data, "--rollout", "2", *TINY]
    jax_driver("dr_vchannel_diag").main(args + ["--ckpt", str(dr.jax_ckpt),
                                                "--out", str(out / "j.json")])
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    port_driver("dr_vchannel_diag").main(args + ["--ckpt", str(dr.port_ckpt),
                                                 "--out", str(out / "t.json"), *CPU])
    torch.set_num_threads(n)
    return (json.loads((out / "t.json").read_text()), json.loads((out / "j.json").read_text()))


@pytest.mark.parametrize("prec,rtol", [("fp32", 1e-5), ("bf16", 3e-2)])
def test_vchannel_table_matches_jax(vchannel, prec, rtol):
    got, want = vchannel
    assert set(got) == set(want)
    for t0 in (0, 20):
        key = f"{prec}_t0={t0}"
        assert_nested_close(got[key], want[key], rtol=rtol, path=key)
        for k in (1, 2):  # the targets' RMS does not depend on the model
            np.testing.assert_allclose(got[key][f"r{k}_tgt_rms"], want[key][f"r{k}_tgt_rms"],
                                       rtol=1e-6)


def test_early_window_finetune_matches_optax(dr, tmp_path, capsys):
    """Three steps (2 trajectories x t0 0..5, batch 4) from one tree in f32:
    optax's clip, adamw and cosine schedule against the port's."""
    args = ["--data", dr.data, "--n-train", "2", "--t0-max", "5", "--epochs", "1",
            "--precision", "fp32", *TINY]

    def epoch_loss():
        line = [s for s in capsys.readouterr().out.splitlines() if s.startswith("epoch 0:")]
        return float(line[0].split("loss=")[1])

    jax_driver("dr_early_window_finetune").main(args + ["--ckpt", str(dr.jax_ckpt),
                                                        "--out", str(tmp_path / "j.json")])
    want_loss = epoch_loss()
    got = port_driver("dr_early_window_finetune").main(
        args + ["--ckpt", str(dr.port_ckpt), "--out", str(tmp_path / "t.json"), *CPU])
    assert abs(epoch_loss() - want_loss) <= 1e-5
    want = json.loads((tmp_path / "j.json").read_text())
    assert_nested_close({k: got[k] for k in ("before", "after")},
                        {k: want[k] for k in ("before", "after")}, rtol=1e-5)
    assert got["before"] != got["after"]


def test_early_window_steps_match_optax(dr):
    """``finetune``'s three steps against the JAX driver's step (optax's
    chain, JAX's losses) on the same windows in the same order: each
    step's loss and the weights after, f32, within 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax

    from sciml_pde_tpu.models.transformer import VideoMAEOperator
    from sciml_pde_tpu.train.transformer_train import fft_relative_l2, transformer_nrmse_sqrt
    from sciml_pde_torch.data.dr import PRIMARY_FILE, _load_train_pool
    from sciml_pde_torch.experiments import _dr_vmae
    from sciml_pde_torch.utils.weights import transformer_state_dict_to_flax

    ew = port_driver("dr_early_window_finetune")
    train = np.asarray(_load_train_pool(Path(dr.data), PRIMARY_FILE, 2, None)[0])
    idx, lr = ew.window_index(2, 5), 5e-5
    model = _dr_vmae.build(types.SimpleNamespace(**WIDTHS), torch.float32, dr.tree)
    got_losses = ew.finetune(model, torch.as_tensor(train), idx, 1, 4, lr, log=lambda s: None)

    jmodel = VideoMAEOperator(img_size=128, patch_size=16, tubelet_size=1, in_chans=2,
                              num_frames=10, **WIDTHS)
    jtrain = jnp.asarray(train)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(lr, 3), weight_decay=0.05))

    @jax.jit
    def step(pp, st, rows):
        x = jtrain[rows[:, 0, None], rows[:, 1, None] + jnp.arange(10)[None]]
        y = jtrain[rows[:, 0], rows[:, 1] + 10]

        def loss_fn(q):
            pred = jmodel.apply({"params": q}, x)
            return transformer_nrmse_sqrt(pred, y) + 0.1 * fft_relative_l2(pred, y)

        loss, grads = jax.value_and_grad(loss_fn)(pp)
        updates, st = tx.update(grads, st, pp)
        return optax.apply_updates(pp, updates), st, loss

    params, st, want_losses = dr.tree, tx.init(dr.tree), []
    order = np.random.default_rng(0).permutation(len(idx))
    for b in range(0, len(idx) - 3, 4):
        params, st, loss = step(params, st, jnp.asarray(idx[order[b:b + 4]]))
        want_losses.append(float(loss))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert_trees_close(transformer_state_dict_to_flax(model.state_dict()),
                       to_numpy_tree(params), rtol=1e-5, atol=1e-7, what="fine-tuned weights")


def test_dr_data_audit_matches_jax(tmp_path):
    """scipy's trajectories are the same f64 solves of the same IC; the RK4
    generators' RMS within 1e-5."""
    from sciml_pde_tpu.sim.diff_react import DiffReactConfig as JaxCfg
    from sciml_pde_torch.sim.diff_react import DiffReactConfig as PortCfg

    jda, tda = jax_driver("dr_data_audit"), port_driver("dr_data_audit")
    want_traj = jda.scipy_traj(90, JaxCfg(xdim=16, ydim=16), 1e-3, 1e-6)
    np.testing.assert_array_equal(tda.scipy_traj(90, PortCfg(xdim=16, ydim=16), 1e-3, 1e-6),
                                  want_traj)
    jda.main(["--grid", "16", "--out", str(tmp_path / "j.json")])
    got = tda.main(["--grid", "16", "--out", str(tmp_path / "t.json"), *CPU])
    want = json.loads((tmp_path / "j.json").read_text())
    rel = {k for k in want if "rel_l2" in k}
    assert_nested_close({k: v for k, v in got.items() if k not in rel},
                        {k: v for k, v in want.items() if k not in rel}, rtol=1e-5)
    for k in rel:  # differences of near-equal fields: f32 noise of the fields' scale
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_test_family_audit_matches_jax(tmp_path, monkeypatch):
    """persistence_nrmse on the same arrays, then both drivers at 16^2 x 16
    frames (the reference config's 70 seeds at 128^2 x 101 frames are the
    card's work)."""
    from sciml_pde_tpu.sim import diff_react as jdr
    from sciml_pde_torch.sim import diff_react as tdr

    jfa, tfa = jax_driver("dr_test_family_audit"), port_driver("dr_test_family_audit")
    assert tfa.FAMILIES == jfa.FAMILIES
    traj = np.random.default_rng(2).normal(size=(3, 16, 8, 8, 2)).astype(np.float32)
    for h in (1, 3, 5):
        assert tfa.persistence_nrmse(traj, 10, h) == jfa.persistence_nrmse(traj, 10, h)
    small = dict(xdim=16, ydim=16, tdim=16, t=0.75)
    monkeypatch.setattr(jdr, "DiffReactConfig", functools.partial(jdr.DiffReactConfig, **small))
    monkeypatch.setattr(tdr, "DiffReactConfig", functools.partial(tdr.DiffReactConfig, **small))
    jfa.main(["--out", str(tmp_path / "j"), "--subset-draws", "20"])
    got = tfa.main(["--out", str(tmp_path / "t"), "--subset-draws", "20", *CPU])
    want = json.loads((tmp_path / "j" / "dr_test_family_audit.json").read_text())
    assert_nested_close(json.loads(json.dumps(got)), want, rtol=1e-5)


def test_seed_figure_collects_as_jax(tmp_path):
    runs = tmp_path / "runs"
    rows = {2: {"baseline": [0.1, 0.2], "baseline_s99": [0.12, 0.2], "aux_s16": [0.09, 0.1]},
            8: {"baseline_s17": [0.05, 0.1], "aux": [0.04, 0.1], "aux_s99": {"x": 1}},
            32: {"other": [1.0]}}
    for n, r in rows.items():
        (runs / f"dr_parity_ds{n}").mkdir(parents=True)
        (runs / f"dr_parity_ds{n}" / "summary.json").write_text(
            json.dumps({k: v if isinstance(v, dict) else {"rollout_nrmse": v}
                        for k, v in r.items()}))
    jsf, tsf = jax_driver("dr_seed_figure"), port_driver("dr_seed_figure")
    presets, variants = [2, 4, 8, 32], ["baseline", "aux"]
    want = jsf.collect(runs, presets, variants)
    assert tsf.collect(runs, presets, variants) == want and set(want["baseline"]) == {2, 8}
    args = ["--run-root", str(runs), "--horizon", "2"]
    jsf.main(args + ["--out", str(tmp_path / "j")])
    tsf.main(args + ["--out", str(tmp_path / "t")])
    name = "dr_seed_data_efficiency.json"
    assert (json.loads((tmp_path / "t" / name).read_text())
            == json.loads((tmp_path / "j" / name).read_text()))


GATE_TABLES = {
    "pass": ([0.10, 0.20, 0.30, 0.40, 0.50], [0.101, 0.203, 0.30, 0.39, 0.51]),
    "fail": ([0.10, 0.20, 0.30, 0.40, 0.50], [0.101, 0.203, 0.35, 0.39, 0.51]),
}


@pytest.mark.parametrize("case", GATE_TABLES)
def test_dft_gate_verdict_matches_jax(tmp_path, monkeypatch, case):
    """Both drivers with training and the rollout study replaced by fixed
    tables (highest first, then default): the same degradation and
    verdict."""
    from sciml_pde_tpu.data import dr as jdata
    from sciml_pde_tpu.eval import rollout_experiment as jre
    from sciml_pde_tpu.train import fno_train as jft
    from sciml_pde_torch.data import dr as tdata
    from sciml_pde_torch.eval import rollout_experiment as tre
    from sciml_pde_torch.train import fno_train as tft

    tables = iter([])

    def fake_train(**_):
        return types.SimpleNamespace(params=tft.default_init_tree(2, 4, 8, 10, seed=0),
                                     best_val=0.25)

    def fake_study(*_, **__):
        row = next(tables)
        return {k: {"nRMSE": row[k - 1]} for k in (1, 2, 3, 4, 5)}

    for mod in (jft, tft):
        monkeypatch.setattr(mod, "run_training", fake_train)
    for mod in (jre, tre):
        monkeypatch.setattr(mod, "rollout_study", fake_study)
    monkeypatch.setattr(jdata, "load_dr_baseline", lambda *a, **k: types.SimpleNamespace(test=None))
    monkeypatch.setattr(tdata, "load_dr_test", lambda *a, **k: None)
    summaries = []
    for drv, out, extra in ((jax_driver("dft_precision_gate"), "j", []),
                            (port_driver("dft_precision_gate"), "t", CPU)):
        tables = iter(GATE_TABLES[case])
        drv.main(["--modes", "4", "--width", "8", "--out", str(tmp_path / out), *extra])
        s = json.loads((tmp_path / out / "summary.json").read_text())
        for mode in ("highest", "default"):
            s[mode].pop("train_seconds")
        s.pop("train_speedup")
        summaries.append(s)
    assert summaries[0] == summaries[1]
    assert summaries[1]["verdict"] == case.upper()


@pytest.mark.parametrize("backend", ["h5py", "hdf5_lite"])
def test_build_toy_folder_matches_jax(tmp_path, monkeypatch, backend):
    """The toy files of one source, JAX's through h5py against the port's
    through ``backend`` (read back with h5py either way)."""
    import h5py

    from sciml_pde_torch.sim.gen_ns_incomp import write_ns_h5

    rng = np.random.default_rng(4)
    arrays = (rng.normal(size=(4, 6, 16, 16, 2)), rng.normal(size=(4, 6, 16, 16, 1)),
              rng.normal(size=(4, 16, 16, 2)), np.tile(np.linspace(0, 1, 6), (4, 1)))
    write_ns_h5(tmp_path / "src_j.h5", *arrays, {"nu": 0.05})
    jax_driver("ns_lie_toy").build_toy_folder(tmp_path / "src_j.h5", tmp_path / "j", 4, 2)
    if backend == "hdf5_lite":
        monkeypatch.setitem(sys.modules, "h5py", None)
    write_ns_h5(tmp_path / "src_t.h5", *arrays, {"nu": 0.05})
    port_driver("ns_lie_toy").build_toy_folder(tmp_path / "src_t.h5", tmp_path / "t", 4, 2)
    monkeypatch.setitem(sys.modules, "h5py", h5py)
    for name in ("ns_incom_inhom_2d_256-0.h5", "ns_incom_inhom_2d_256-250.h5"):
        with h5py.File(tmp_path / "j" / name, "r") as fj, h5py.File(tmp_path / "t" / name) as ft:
            assert sorted(fj) == sorted(ft) == ["force", "particles", "t", "velocity"]
            for k in fj:
                np.testing.assert_array_equal(ft[k][()], fj[k][()], err_msg=f"{name}/{k}")
            assert dict(ft.attrs) == dict(fj.attrs)
            assert fj["velocity"].shape[:3] == ((3,) if name.endswith("-0.h5") else (1,)) + (3, 4)


def test_round_figures_draw_jax_panels(tmp_path, monkeypatch):
    """Run from the repository root: the same panels from the same
    summaries (the tracked experiments/results snapshots)."""
    monkeypatch.chdir(Path(__file__).resolve().parents[1])
    want = jax_driver("make_round_figures").main(str(tmp_path / "j"))
    got = port_driver("make_round_figures").main(str(tmp_path / "t"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] and len(got) >= 3
