"""The ported perf probe (sciml_pde_torch/experiments/perf_probe.py) on the
CPU at a tiny size: one config of each kind runs without error, its
results are finite and carry the JAX probe's keys; the subprocess runner
writes its results file; without a CUDA device it raises unless the CPU is
asked for."""

import json

import numpy as np
import pytest
import torch

from sciml_pde_torch.experiments import perf_probe as pp

TINY = {"PROBE_NX": "16", "PROBE_MODES": "4", "PROBE_SCAN_K": "2", "PROBE_ITERS": "2"}
# the keys of the JAX probe's result per config kind (experiments/perf_probe.py);
# the port's forward rollout adds `finite`, which the JAX one leaves out
TIMING = {"config", "batch", "scan_k", "device", "compile_s", "steps_per_sec",
          "steps_per_sec_windows", "step_ms"}
KEYS = {"prod": TIMING | {"final_loss"}, "fused": TIMING | {"final_loss"},
        "iso": TIMING | {"finite"}, "fused_fwd": TIMING | {"finite"}}
ONE_OF_EACH = ["prod_f32", "iso_bbfwd", "iso_headfwd", "iso_headbwd", "iso_bbbwd", "iso_wgrad",
               "fused_bf16", "fused_fwd"]


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(pp, "ROLLOUT_K", 5)  # fused_fwd's rollout length (100 on the card)


def test_configs_keep_the_jax_names():
    assert list(pp.CONFIGS) == ["prod_f32", "prod_bf16", "iso_bbfwd", "iso_headfwd",
                                "iso_headbwd", "iso_bbbwd", "iso_wgrad", "fused_f32",
                                "fused_bf16", "fused_fwd", "fused_b64"]


@pytest.mark.parametrize("name", ONE_OF_EACH)
def test_config_runs_on_cpu(tiny, name):
    res = pp.run_config(name, "cpu")
    assert "error" not in res, res
    assert set(res) == KEYS[pp.CONFIGS[name]["kind"]], res
    assert pp.ok(res) and res["device"] == "cpu"
    assert all(np.isfinite(v) for v in (res["steps_per_sec"], res["step_ms"], res["compile_s"]))
    assert len(res["steps_per_sec_windows"]) == 3


def test_main_runs_each_config_in_a_subprocess(tiny, tmp_path):
    out = tmp_path / "probe.json"
    pp.main(["--configs", "iso_headfwd", "--device", "cpu", "--out", str(out)])
    res = json.loads(out.read_text())["iso_headfwd"]
    assert set(res) == KEYS["iso"] | {"wall_s"} and pp.ok(res), res


def test_main_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pp.main(["--configs", "iso_headfwd", "--out", str(tmp_path / "probe.json")])
    assert not (tmp_path / "probe.json").exists()
