"""The port's five comparison drivers (``sciml_pde_torch/experiments/``)
end to end on the CPU at a tiny size, through ``main(argv)`` with JAX's
arguments plus ``--device cpu``: each writes JAX's ``summary.json`` keys,
every number finite.  The DR driver reads a DR file; the others generate
their data with the port's simulators (Burgers, Darcy, BVP, airfoil; the
airfoil's settle phase cut) or the synthetic generators."""

import json
import math

import pytest

from _torch_dr_files import write_dr
from _torch_parity import few_threads  # noqa: F401


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


CASES = {
    "comparison_dr": (["--in-seq", "4", "--out-seq", "3", "--train-subsample", "3",
                       "--epochs", "1", "--batch-size", "1", "--models", "oformer"],
                      {"oformer_protocol"}),
    "oformer_burgers_darcy": (["--burgers-n", "2", "--burgers-nx", "32", "--darcy-n", "8",
                               "--darcy-nx", "16", "--epochs", "1"], {"burgers", "darcy"}),
    "pointset_bvp_demo": (["--epochs", "1", "--n-train", "16", "--n-test", "8",
                           "--max-points", "32"], {"bvp_electrostatics", "airfoil_vortex_sheet"}),
    "bvp_study": (["--n-train", "4", "--n-test", "2", "--grid", "32", "--epochs", "1",
                   "--batch-size", "2", "--kinds", "electro"], {"electro"}),
    "airfoil_flow": (["--n-train", "1", "--n-test", "1", "--nx", "64", "--frames", "8",
                      "--epochs", "1", "--emb-dim", "16", "--latent", "16", "--depth", "2"],
                     {"airfoil_euler"}),
}


@pytest.mark.parametrize("name", CASES)
def test_driver_writes_its_summary(tmp_path, monkeypatch, name):
    import functools
    import importlib

    from sciml_pde_torch.sim import airfoil_2d

    # the airfoil's settle phase (0.05 s of flow) cut to 2 ms: its steps are
    # the generator's, tested in test_torch_sim_bvp_airfoil.py
    monkeypatch.setattr(airfoil_2d, "AirfoilConfig",
                        functools.partial(airfoil_2d.AirfoilConfig, settle_time=2e-3))
    mod = importlib.import_module(f"sciml_pde_torch.experiments.{name}")
    args, keys = CASES[name]
    data = write_dr(tmp_path) if name == "comparison_dr" else str(tmp_path / "data")
    extra = [] if name == "pointset_bvp_demo" else ["--data", data]
    out = tmp_path / "out"
    res = mod.main(args + extra + ["--out", str(out), "--device", "cpu"])
    summary = json.loads((out / "summary.json").read_text())
    assert set(summary) == keys and summary == json.loads(json.dumps(res))
    assert _finite(summary)
