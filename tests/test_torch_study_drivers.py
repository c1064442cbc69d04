"""The port's study drivers (``sciml_pde_torch/experiments/``, the JAX
package's ``experiments/`` of the same names) end to end on the CPU at a
tiny size, through ``main(argv)`` with JAX's arguments plus ``--device
cpu``: each writes JAX's keys, every number finite.  The DR VideoMAE runs
at its hard-coded shape (128^2, patch 16, 10 frames) at encoder and
decoder 16 x 1 x 2 heads in f32; its three diagnostics restore its
baseline checkpoint.  Without ``--device`` each driver that computes on a
device refuses to run on a host without a card."""

import json
import math
import sys

import numpy as np
import pytest
import torch

from _torch_dr_files import write_dr128
from _torch_parity import few_threads  # noqa: F401

TINY = ["--encoder-dim", "16", "--encoder-depth", "1", "--encoder-heads", "2",
        "--decoder-dim", "16", "--decoder-depth", "1", "--decoder-heads", "2"]
CPU = ["--device", "cpu"]


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """dr_transformer's baseline and aux for one epoch at basic_ds2 on the
    128^2 files: (data folder, out folder, summary)."""
    from sciml_pde_torch.experiments import dr_transformer

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("dr")
    data = write_dr128(root)
    out = root / "out"
    res = dr_transformer.main(["--data", data, "--dataset", "basic_ds2", "--epochs", "1",
                               "--precision", "fp32", "--out", str(out), *TINY, *CPU])
    torch.set_num_threads(n)
    return data, out, res


def test_dr_transformer_writes_jax_keys(trained):
    _, out, res = trained
    summary = json.loads((out / "summary.json").read_text())
    assert summary == json.loads(json.dumps(res))
    assert set(summary) == {"basic_ds2_baseline", "basic_ds2_aux"}
    for key, row in summary.items():
        assert set(row) == {"best_val", "train_seconds", "val_history", "rollout_nrmse",
                            "rollout_nrmse_allsteps", "swa_rollout_nrmse"}, key
        assert len(row["rollout_nrmse"]) == 5 and _finite(row)
        np.testing.assert_allclose(row["rollout_nrmse_allsteps"],
                                   np.cumsum(row["rollout_nrmse"]) / np.arange(1, 6))
        assert (out / f"vmae_dr_{key}_ckpt").exists()
    # the aux recipe keeps SWA weights (swa_frac 0.1 of one epoch: the last)
    assert summary["basic_ds2_aux"]["swa_rollout_nrmse"] is not None
    assert summary["basic_ds2_baseline"]["swa_rollout_nrmse"] is None


def test_dr_transformer_eval_only_restores_the_best_checkpoint(trained, tmp_path):
    """--eval-only scores the checkpoint the training run scored."""
    import shutil

    from sciml_pde_torch.experiments import dr_transformer

    data, out, res = trained
    shutil.copytree(out / "vmae_dr_basic_ds2_baseline_ckpt",
                    tmp_path / "vmae_dr_basic_ds2_baseline_ckpt")
    got = dr_transformer.main(["--data", data, "--dataset", "basic_ds2", "--eval-only",
                               "--variants", "baseline", "--precision", "fp32",
                               "--out", str(tmp_path), *TINY, *CPU])
    row, want = got["basic_ds2_baseline"], res["basic_ds2_baseline"]
    assert row["train_seconds"] == 0.0 and row["val_history"] is None
    assert row["best_val"] == want["best_val"]
    np.testing.assert_allclose(row["rollout_nrmse"], want["rollout_nrmse"], rtol=1e-6)


def test_convention_eval_writes_four_rows(trained, tmp_path, capsys):
    from sciml_pde_torch.experiments import dr_convention_eval

    data, out, _ = trained
    ckpt = out / "vmae_dr_basic_ds2_baseline_ckpt"
    res = dr_convention_eval.main(["--data", data, "--ckpts", f"baseline={ckpt}",
                                   f"aux={tmp_path / 'missing.pt'}", "--rollout", "3",
                                   "--out", str(tmp_path / "ce.json"), *TINY, *CPU])
    assert "skip aux: no checkpoint" in capsys.readouterr().out
    saved = json.loads((tmp_path / "ce.json").read_text())
    assert saved == json.loads(json.dumps(res)) and set(saved) == {"baseline"}
    row = saved["baseline"]
    assert set(row) == {"joint_final", "joint_all", "perch_final", "perch_all", "best_val",
                        "published"}
    assert all(len(row[k]) == 3 for k in ("joint_final", "joint_all", "perch_final",
                                          "perch_all"))
    assert row["published"] == dr_convention_eval.PUBLISHED["baseline"] and _finite(row)
    # one step: the final step is all the steps
    assert row["joint_all"][0] == row["joint_final"][0]


def test_vchannel_diag_writes_both_precisions(trained, tmp_path):
    from sciml_pde_torch.experiments import dr_vchannel_diag

    data, out, _ = trained
    res = dr_vchannel_diag.main(["--data", data, "--ckpt",
                                 str(out / "vmae_dr_basic_ds2_baseline_ckpt"),
                                 "--rollout", "2", "--out", str(tmp_path / "vc.json"),
                                 *TINY, *CPU])
    saved = json.loads((tmp_path / "vc.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == {"bf16_t0=0", "bf16_t0=20", "fp32_t0=0", "fp32_t0=20"}
    for row in saved.values():
        assert set(row) == {"r1", "r1_tgt_rms", "r2", "r2_tgt_rms"}
        assert all(len(v) == 2 for v in row.values()) and _finite(row)


def test_early_window_finetune_writes_before_and_after(trained, tmp_path):
    from sciml_pde_torch.experiments import dr_early_window_finetune as ew

    data, out, _ = trained
    res = ew.main(["--data", data, "--ckpt", str(out / "vmae_dr_basic_ds2_baseline_ckpt"),
                   "--n-train", "2", "--t0-max", "3", "--epochs", "1", "--precision", "fp32",
                   "--out", str(tmp_path / "ew.json"), *TINY, *CPU])
    saved = json.loads((tmp_path / "ew.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == {"before", "after", "config"}
    for part in ("before", "after"):
        assert set(saved[part]) == {"t0=0", "t0=20"} and _finite(saved[part])
        assert set(saved[part]["t0=0"]) == {"r1", "r2", "r3"}
    assert saved["before"] != saved["after"]  # the two steps moved the weights
    assert ew.window_index(2, 3).tolist() == [[n, t] for n in range(2) for t in range(4)]


def test_dft_precision_gate_writes_its_verdict(tmp_path):
    from sciml_pde_torch.experiments import dft_precision_gate

    data = write_dr128(tmp_path, frames=16)
    out = tmp_path / "gate"
    res = dft_precision_gate.main(["--data", data, "--dataset", "basic_ds2", "--epochs", "1",
                                   "--modes", "4", "--width", "8", "--out", str(out), *CPU])
    saved = json.loads((out / "summary.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == {"highest", "default", "relative_degradation_r1_5", "tol",
                          "train_speedup", "verdict"}
    assert saved["verdict"] in ("PASS", "FAIL") and _finite(saved)
    for mode in ("highest", "default"):
        assert set(saved[mode]) == {"best_val", "train_seconds", "rollout_nrmse"}
        assert (out / f"rollout_{mode}.json").exists()


def test_ns_demo_generates_trains_and_scores(tmp_path):
    from sciml_pde_torch.experiments import ns_demo

    res = ns_demo.main(["--folder", str(tmp_path / "ns"), "--out", str(tmp_path / "out"),
                        "--grid", "32", "--frames", "16", "--frame-int", "2",
                        "--n-primary", "1", "--n-aux-per", "1", "--n-test", "1",
                        "--epochs", "1", *CPU])
    saved = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert saved == json.loads(json.dumps(res)) and set(saved) == {"baseline", "aux"}
    for row in saved.values():
        assert set(row) == {"best_val", "rollout_nrmse"} and len(row["rollout_nrmse"]) == 5
        assert _finite(row)
    names = sorted(p.name for p in (tmp_path / "ns").iterdir())
    assert names == ["ns_aux_2d_256-0.h5", "ns_aux_2d_256-250.h5", "ns_incom_inhom_2d_256-0.h5",
                     "ns_incom_inhom_2d_256-250.h5"]


def _ns_source(path, traj=4, frames=16, grid=128, seed=0):
    from sciml_pde_torch.sim.gen_ns_incomp import write_ns_h5

    rng = np.random.default_rng(seed)
    write_ns_h5(path, rng.normal(size=(traj, frames, grid, grid, 2)),
                rng.normal(size=(traj, frames, grid, grid, 1)),
                rng.normal(size=(traj, grid, grid, 2)),
                np.tile(np.linspace(0, 1, frames), (traj, 1)), {"grid": grid})


def test_ns_lie_toy_trains_both_variants(tmp_path):
    """A 128^2 source strided by 4: the 32^2 toy the production driver's
    modes 12 take."""
    from sciml_pde_torch.experiments import ns_lie_toy

    _ns_source(tmp_path / "src.h5")
    res = ns_lie_toy.main(["--src", str(tmp_path / "src.h5"), "--folder", str(tmp_path / "toy"),
                           "--out", str(tmp_path / "out"), "--epochs", "1", *CPU])
    assert set(res) == {"baseline_toy64", "lie_toy64"} and _finite(res)
    for row in res.values():
        assert len(row["rollout_nrmse"]) == 5


def test_dr_data_audit_reports_rms_and_rel_l2(tmp_path):
    from sciml_pde_torch.experiments import dr_data_audit

    res = dr_data_audit.main(["--grid", "16", "--out", str(tmp_path / "a.json"), *CPU])
    saved = json.loads((tmp_path / "a.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == {"seed", "grid", "frames", "rk4_ours", "rk45_ref_tol", "rk45_tight",
                          "frame10_rel_l2_ours_vs_reftol", "frame10_rel_l2_reftol_vs_tight",
                          "frame10_rel_l2_ours_vs_tight"}
    assert _finite(saved) and len(saved["rk4_ours"]["v_rms"]) == 6
    # the fixed-step RK4 lies nearer the tight solve than RK45 at its defaults
    assert saved["frame10_rel_l2_ours_vs_tight"] < saved["frame10_rel_l2_reftol_vs_tight"]


def test_dr_test_family_audit_at_a_reduced_config(tmp_path, monkeypatch):
    """The reference's 128^2 x 101 frames for 70 seeds is the card's work;
    here the same driver at 16^2 x 16 frames."""
    import functools

    from sciml_pde_torch.experiments import dr_test_family_audit as fa
    from sciml_pde_torch.sim import diff_react

    monkeypatch.setattr(diff_react, "DiffReactConfig",
                        functools.partial(diff_react.DiffReactConfig, xdim=16, ydim=16,
                                          tdim=16, t=0.75))
    res = fa.main(["--out", str(tmp_path), "--subset-draws", "20", *CPU])
    saved = json.loads((tmp_path / "dr_test_family_audit.json").read_text())
    assert saved == json.loads(json.dumps(res)) and _finite(saved)
    assert set(saved["families"]) == set(fa.FAMILIES)
    assert "r1_subset10_mean_std" not in saved["families"]["A_seeds_90_99"]
    assert saved["families"]["B_seeds_900_929"]["r1_subset10_mean_std"] > 0


def _png_ok(path) -> bool:
    from PIL import Image

    with Image.open(path) as im:
        return len(im.convert("RGB").getcolors(1 << 20) or ()) > 1


def test_figure_drivers_run_without_matplotlib(tmp_path, monkeypatch):
    from sciml_pde_torch.experiments import dr_seed_figure, make_round_figures

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runs = tmp_path / "runs"
    for n, rows in ((2, {"baseline": [0.1] * 5, "aux_s99": [0.2] * 5}),
                    (8, {"baseline": [0.05] * 5, "baseline_s17": [0.07] * 5})):
        (runs / f"dr_parity_ds{n}").mkdir(parents=True)
        (runs / f"dr_parity_ds{n}" / "summary.json").write_text(
            json.dumps({k: {"rollout_nrmse": v} for k, v in rows.items()}))
    agg = dr_seed_figure.main(["--run-root", str(runs), "--out", str(tmp_path / "fig")])
    assert set(agg) == {"baseline", "aux"} and set(agg["aux"]) == {"2"}
    assert agg["baseline"]["8"]["seeds"] == [16, 17]
    assert _png_ok(tmp_path / "fig" / "dr_seed_data_efficiency.png")
    made = make_round_figures.main(str(tmp_path / "round"))
    assert made and all(_png_ok(p) for p in made)


DEVICE_DRIVERS = ["dr_transformer", "dr_convention_eval", "dr_vchannel_diag",
                  "dr_early_window_finetune", "dft_precision_gate", "ns_demo", "ns_lie_toy",
                  "dr_data_audit", "dr_test_family_audit"]


@pytest.mark.parametrize("name", DEVICE_DRIVERS)
def test_driver_raises_without_cuda(tmp_path, name):
    """Each runs on the card unless the CPU is asked for, and writes no
    file before it refuses."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import importlib

    mod = importlib.import_module(f"sciml_pde_torch.experiments.{name}")
    out = str(tmp_path / "out")
    args = {"dr_data_audit": ["--out", out], "ns_lie_toy": ["--src", out, "--out", out],
            "ns_demo": ["--folder", out, "--out", out]}.get(name, ["--out", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(args)
    assert not list(tmp_path.rglob("*"))
