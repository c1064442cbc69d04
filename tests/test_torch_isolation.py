"""The port imports neither JAX nor the JAX package, and its entry points
refuse to run without a CUDA device unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Every module of the port, as pkgutil.walk_packages finds it, imports
    without pulling in JAX, the JAX package, orbax, tensorstore or
    zstandard, and with h5py, matplotlib, orbax, tensorstore and zstandard
    not importable (the card's machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('h5py', 'matplotlib', 'orbax', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        "import sciml_pde_torch as pkg\n"
        "mods = ['sciml_pde_torch'] + [m.name for m in "
        "pkgutil.walk_packages(pkg.__path__, 'sciml_pde_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print('MODULES', len(mods), mods)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and "
        "m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard', "
        "'sciml_pde_tpu'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "assert {'sciml_pde_torch.experiments.wide_attention_ablation', "
        "'sciml_pde_torch.metrics.metrics', 'sciml_pde_torch.ops.attention', "
        "'sciml_pde_torch.sim.ns_incomp_2d', 'sciml_pde_torch.sim.gen_diff_react', "
        "'sciml_pde_torch.experiments.dr_parity', 'sciml_pde_torch.sweep', "
        "'sciml_pde_torch.eval.rollout_experiment', 'sciml_pde_torch.plots.figures', "
        "'sciml_pde_torch.io.hdf5_lite', 'sciml_pde_torch.io.lzf', "
        "'sciml_pde_torch.io.filters', 'sciml_pde_torch.sim.ns_plume_3d', "
        "'sciml_pde_torch.io.zstd', 'sciml_pde_torch.io.ocdbt', 'sciml_pde_torch.io.zarr2', "
        "'sciml_pde_torch.utils.orbax_tree', "
        "'sciml_pde_torch.sim.burgers_1d', 'sciml_pde_torch.sim.darcy_2d', "
        "'sciml_pde_torch.sim.bvp_2d', 'sciml_pde_torch.sim.airfoil_2d', "
        "'sciml_pde_torch.experiments.plume3d_parity', "
        "'sciml_pde_torch.experiments.plume3d_demo', 'sciml_pde_torch.data.stream', "
        "'sciml_pde_torch.data.generic', 'sciml_pde_torch.utils.transfer', "
        "'sciml_pde_torch.utils.export', 'sciml_pde_torch.utils.upload', "
        "'sciml_pde_torch.parallel.distributed', 'sciml_pde_torch.parallel.mesh', "
        "'sciml_pde_torch.train.placement', 'sciml_pde_torch.experiments.ns_production', "
        "'sciml_pde_torch.experiments.ns_transformer'} <= set(mods)\n"
        "assert {'sciml_pde_torch.experiments.' + m for m in ('dr_transformer', "
        "'dr_convention_eval', 'dr_vchannel_diag', 'dr_early_window_finetune', "
        "'dft_precision_gate', 'ns_demo', 'ns_lie_toy', 'dr_data_audit', "
        "'dr_test_family_audit', 'dr_seed_figure', 'make_round_figures')} <= set(mods)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
                        "sciml_pde_tpu"}, names


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from sciml_pde_torch import resolve_device
    from sciml_pde_torch.train.fno_train import run_training
    from sciml_pde_torch.train.transformer_train import run_transformer_training

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(base_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(base_path=str(tmp_path), fast_step=False, training_type="autoregressive")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_transformer_training(base_path=str(tmp_path), if_aux=False)
    # device="cpu" gets past the device check to the (missing) data files
    with pytest.raises(OSError):
        run_transformer_training(base_path=str(tmp_path), if_aux=False, device="cpu")
    assert resolve_device("cpu").type == "cpu"


def test_data_and_eval_entry_points_raise_without_cuda(tmp_path):
    """The simulators, generators, rollout study, export, sweep, the chunked
    transfer, the process group and the DR, plume and NS production
    drivers run on the card unless the CPU is asked for, and write no file
    before they refuse."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import numpy as np

    from sciml_pde_torch import sweep
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.eval.prediction import export_rollout_trajectories
    from sciml_pde_torch.eval.rollout_experiment import rollout_study
    from sciml_pde_torch.experiments import (dr_parity, ns_production, ns_transformer,
                                             plume3d_demo, plume3d_parity)
    from sciml_pde_torch.parallel import distributed_init
    from sciml_pde_torch.utils.transfer import device_put_chunked
    from sciml_pde_torch.sim import (airfoil_2d, burgers_1d, bvp_2d, darcy_2d, diff_react,
                                     gen_diff_react, gen_ns_incomp, grf, ns_incomp_2d,
                                     ns_plume_3d)
    from sciml_pde_torch.sim.velocity2vorticity import convert_velocity

    dr = diff_react.DiffReactConfig(xdim=8, ydim=8, tdim=3, t=0.1)
    ns = ns_incomp_2d.NSIncompConfig(grid_size=(8, 8), n_steps=3, frame_int=1, n_batch=1)
    plume = ns_plume_3d.Plume3DConfig(res=(4, 4, 4), n_frames=1, substeps=1, out_res=(4, 4, 4),
                                      out_frames=1)
    w = WindowedTrajectories(np.zeros((1, 8, 8, 8, 2), np.float32),
                             np.zeros((8, 8, 2), np.float32), initial_step=4, train=False,
                             device="cpu")
    calls = [
        lambda: diff_react.simulate_diff_react(np.zeros((8, 8, 2), np.float32), dr),
        lambda: diff_react.generate_trajectories([0], dr),
        lambda: gen_diff_react.generate_dataset(tmp_path / "dr.h5", 1, dr),
        lambda: grf.spectral_noise(torch.Generator(), (8, 8)),
        lambda: ns_incomp_2d.init_state(torch.Generator(), ns),
        lambda: ns_incomp_2d.simulate_ns_batch(0, ns),
        lambda: gen_ns_incomp.generate_ns_file(tmp_path / "ns.h5", 0, ns),
        lambda: convert_velocity(tmp_path / "cfd.h5"),
        lambda: rollout_study(lambda x, g: x[..., -1:, :], None, w, horizons=(1,)),
        lambda: export_rollout_trajectories(lambda p, x, g: x[..., -1:, :], None, w, 1,
                                            tmp_path / "out"),
        lambda: sweep.run_sweep("config_dr", ["basic_ds2"], seeds=[16], variant="baseline",
                                overrides=[f"base_path={tmp_path}/"],
                                out_path=str(tmp_path / "s.json")),
        lambda: dr_parity.main(["--data", str(tmp_path), "--out", str(tmp_path / "p")]),
        lambda: ns_plume_3d.generate_plume_files(tmp_path / "plume", 0, plume),
        lambda: ns_plume_3d.simulate_plume(torch.Generator(), plume),
        lambda: plume3d_parity.main(["--folder", str(tmp_path / "plume"), "--out",
                                     str(tmp_path / "p3")]),
        lambda: plume3d_demo.main(["--folder", str(tmp_path / "plume"), "--out",
                                   str(tmp_path / "p3")]),
        lambda: burgers_1d.generate_burgers_file(tmp_path / "b.h5", n_samples=1, nx=8,
                                                 n_frames=2),
        lambda: burgers_1d.random_sine_ic(torch.Generator(), 1, 8),
        lambda: darcy_2d.generate_darcy_file(tmp_path / "d.h5", n_samples=1, nx=8),
        lambda: darcy_2d.sample_coefficient(torch.Generator(), 1, 8, 8),
        lambda: bvp_2d.generate_case(0, bvp_2d.BVPConfig(grid=8, min_points=20, max_points=30)),
        lambda: bvp_2d.generate_dataset(tmp_path / "bvp.pkl", 1, bvp_2d.BVPConfig(grid=8)),
        lambda: airfoil_2d.simulate(airfoil_2d.AirfoilConfig(nx=16, ny=16, n_frames=1)),
        lambda: airfoil_2d.generate_dataset(str(tmp_path / "af"), [0],
                                            airfoil_2d.AirfoilConfig(nx=16, ny=16, n_frames=1)),
        lambda: ns_production.main(["--folder", str(tmp_path / "ns"), "--out",
                                    str(tmp_path / "np")]),
        lambda: ns_transformer.main(["--data", str(tmp_path / "ns"), "--out",
                                     str(tmp_path / "nt")]),
        lambda: device_put_chunked(np.zeros((4, 2), np.float32), max_chunk_bytes=8),
        lambda: distributed_init("localhost:1", 1, 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not [p.name for p in tmp_path.rglob("*") if p.is_file()]


def test_production_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import numpy as np

    from sciml_pde_torch.data.dr import DRBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.experiments.spectral_impl_bench import bench_shape
    from sciml_pde_torch.train.fno_train import train_baseline

    w = WindowedTrajectories(np.zeros((1, 12, 8, 8, 2), np.float32),
                             np.zeros((8, 8, 2), np.float32), initial_step=5, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_baseline(DRBaselineDataset(train=w, test=w), fast_step=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_shape("dr", batch=1, nx=24, channels=2, steps=1)


def test_kernel_wrappers_refuse_other_devices():
    from sciml_pde_torch.ops import fno_kernels as k

    from sciml_pde_torch.ops import attention as a

    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        k.reduce_rows(torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        a.attention_fwd(*(torch.zeros(1, 8, 16, device="meta"),) * 3, 1.0)
    from sciml_pde_torch.ops import probe, spectral_fused

    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        probe.probe(torch.zeros(8, 128, device="meta"))
    meta = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        spectral_fused.fused_fno_layer_2d(meta(1, 8, 8, 2), meta(2, 2, 2, 2, 2),
                                          meta(2, 2, 2, 2, 2), meta(2, 2), meta(2), 2, 2)
