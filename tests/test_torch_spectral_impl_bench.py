"""The port of experiments/spectral_impl_bench.py runs on the CPU at a tiny
size; its probe reports a missing card as data."""

import json
import math

import pytest

from sciml_pde_torch.experiments import spectral_impl_bench as bench
from sciml_pde_torch.ops import spectral


def test_bench_shape_tiny_on_cpu():
    prev = spectral.get_spectral_impl()
    out = bench.bench_shape("tiny", batch=1, nx=24, channels=2, steps=2, windows=2,
                            device="cpu")
    assert spectral.get_spectral_impl() == prev
    assert out["device"] == "cpu" and (out["shape"], out["batch"], out["nx"]) == ("tiny", 1, 24)
    for impl in ("dft", "dft2"):
        r = out[impl]
        assert len(r["windows"]) == 2 and r["steps_per_sec_median"] > 0
        assert math.isfinite(r["final_loss"])
    # the same seeded weights and batches: the two forms train alike
    assert out["dft"]["final_loss"] == pytest.approx(out["dft2"]["final_loss"], rel=1e-4)
    assert out["speedup_dft2_vs_dft"] > 0
    json.dumps(out)


def test_probe_native_reports_no_card_as_data():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = bench.probe_native()
    assert res["native"] is False and res["platform"] == "cpu"
    assert res["error"]
    json.dumps(res)
