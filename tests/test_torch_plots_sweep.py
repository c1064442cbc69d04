"""Port of ``plots/``, ``sim/preview.py`` and ``sweep.py`` vs the JAX
package's: the published tables equal, every figure written (the port
draws with PIL), the previews of DR and NS files, and the sweep's variants, seeds and JSON
records (one epoch of each package's ``run_sweep`` at 12^2)."""

import inspect
import json

import h5py
import numpy as np
import pytest
from PIL import Image

from sciml_pde_tpu import sweep as jsweep
from sciml_pde_tpu.plots import paper_tables as jtab
from sciml_pde_tpu.sim.diff_react import DiffReactConfig as JaxDRConfig
from sciml_pde_tpu.sim.gen_diff_react import generate_dataset as jax_generate
from sciml_pde_torch import sweep as tsweep
from sciml_pde_torch.plots import figures
from sciml_pde_torch.plots import paper_tables as ttab
from sciml_pde_torch.sim import preview
from sciml_pde_torch.train.fno_train import run_training


def test_paper_tables_are_jax():
    for name in ("ROLLOUT_NRMSE", "MOTIVATION_NRMSE", "SIM_COST_SECONDS"):
        assert getattr(ttab, name) == getattr(jtab, name), name


def _written(path, kind="PNG"):
    assert path.exists() and path.stat().st_size > 0
    with Image.open(path) as im:
        assert im.format == kind and im.width > 50 and im.height > 50
    return path


def test_figures_render(tmp_path):
    rng = np.random.default_rng(0)
    _written(figures.rollout_figure(tmp_path / "r.png", "2D_DR", "FNO", ours=[0.02, 0.03]))
    _written(figures.motivation_figure(tmp_path / "m.png"))
    pred = rng.normal(size=(16, 16, 2)).astype(np.float32)
    _written(figures.field_panels(tmp_path / "f.png", pred, pred * 1.1, channel=1, title="t"))
    pred3 = rng.normal(size=(8, 8, 6, 2)).astype(np.float32)
    _written(figures.field_panels(tmp_path / "f3.png", pred3, pred3))
    _written(figures.data_efficiency_figure(
        tmp_path / "d.png",
        {"ours": [0.04, 0.03, 0.02], "seeded": [[0.05, 0.06], [0.04, 0.05], [0.03, 0.04]]}))
    frames = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    gif = _written(figures.field_animation(tmp_path / "a.gif", frames, channel=1, fps=2), "GIF")
    with Image.open(gif) as im:
        assert im.n_frames == 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("prev")
    small = dict(xdim=12, ydim=12, t=1.0, tdim=9)
    jax_generate(d / "2D_diff-react_test_all.h5", 6, JaxDRConfig(sim_type="all", **small),
                 verbose=False)
    jax_generate(d / "2D_diff-react_test_diff.h5", 12, JaxDRConfig(sim_type="diff", **small),
                 verbose=False)
    rng = np.random.default_rng(1)
    with h5py.File(d / "ns.h5", "w") as f:
        f.create_dataset("velocity", data=rng.normal(size=(2, 6, 10, 10, 2)).astype(np.float32))
        f.create_dataset("particles", data=rng.normal(size=(2, 6, 10, 10, 1)).astype(np.float32))
    return d


def test_preview_dr_and_ns(files, tmp_path):
    for name in ("2D_diff-react_test_diff.h5", "ns.h5"):
        src = tmp_path / name
        src.write_bytes((files / name).read_bytes())
        png, gif = preview.preview_dataset(src, gif=True, channel=0 if name != "ns.h5" else 2)
        assert png.name == src.with_suffix(".preview.png").name
        _written(png)
        _written(gif, "GIF")
    with h5py.File(tmp_path / "empty2.h5", "w"):
        pass
    with pytest.raises(ValueError, match="no trajectory groups"):
        preview.preview_dataset(tmp_path / "empty2.h5")


def test_sweep_variants_are_jax():
    assert tsweep.VARIANTS == jsweep.VARIANTS
    assert tsweep.DEFAULT_SEEDS == jsweep.DEFAULT_SEEDS
    params = inspect.signature(run_training).parameters
    for variant, opts in tsweep.VARIANTS.items():
        assert set(opts) <= set(params), variant


def test_run_sweep_writes_jax_records(files, tmp_path):
    """One epoch of each package's run_sweep (aux, one preset, one seed):
    the same record keys, JAX's history keys, a finite best_val."""
    overrides = [f"base_path={files}/", f"aux_path={files}/", "epochs=1", "width=8", "modes=3",
                 "initial_step=4", "batch_size=8", "log_every=1000"]
    jsweep.run_sweep("config_dr", ["basic_ds2"], seeds=[16], variant="aux",
                     overrides=overrides + [f"run_dir={tmp_path}/j"],
                     out_path=str(tmp_path / "j.json"))
    tsweep.run_sweep("config_dr", ["basic_ds2"], seeds=[16], variant="aux",
                     overrides=overrides + [f"run_dir={tmp_path}/t"],
                     out_path=str(tmp_path / "t.json"), device="cpu")
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    # each history entry holds JAX's keys (the port's trainer adds its first
    # and last step losses)
    assert len(got[0]["history"]) == len(want[0]["history"])
    assert all(set(w) <= set(g) for g, w in zip(got[0]["history"], want[0]["history"]))
    assert (got[0]["preset"], got[0]["seed"], got[0]["variant"]) == ("basic_ds2", 16, "aux")
    assert np.isfinite(got[0]["best_val"])
    assert (tmp_path / "t" / "config_dr_basic_ds2_s16_aux_ckpt").exists()
