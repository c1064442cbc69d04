"""Port of the evaluation extras vs the JAX package's, from one flax FNO2d
tree on the same numpy-seeded test store: ``rollout_study_fused`` /
``rollout_study`` (all six metrics and ``mse_time`` at each horizon, the
JSON they write) through the module's forward and through
``fno2d_fused_apply`` on packed parameters (its plain versions on the
CPU), and ``export_rollout_trajectories`` (the same files, names, shapes
and data).  Under ``highest`` both packages take f32 products: values
within 1e-5 relative."""

import functools
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sciml_pde_tpu.data.windows import WindowedTrajectories as JaxWindows
from sciml_pde_tpu.eval import prediction as jpred
from sciml_pde_tpu.eval import rollout_experiment as jre
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.eval import prediction as tpred
from sciml_pde_torch.eval import rollout_experiment as tre
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.models.fno import FNO2d
from sciml_pde_torch.utils.weights import flax_to_packed, flax_to_state_dict

from _torch_parity import precision, to_numpy_tree

N, NT, X, C, T0, MODES, WIDTH = 5, 12, 12, 2, 4, 3, 8
TOL = 1e-5
NAMES = ("RMSE", "nRMSE", "CSV", "Max", "BD", "F")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(N, 1, X, X, C)).astype(np.float32)
    decay = np.exp(-0.1 * np.arange(NT, dtype=np.float32))[None, :, None, None, None]
    data = base * decay + 0.05 * rng.normal(size=(N, NT, X, X, C)).astype(np.float32)
    grid = rng.uniform(size=(X, X, 2)).astype(np.float32)
    flax_model = FlaxFNO2d(num_channels=C, modes1=MODES, modes2=MODES, width=WIDTH,
                           initial_step=T0)
    params = to_numpy_tree(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, X, X, T0, C)),
                                           jnp.asarray(grid[None]))["params"])
    model = FNO2d(C, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(params))

    def jax_apply(p, x, g):
        return flax_model.apply({"params": p}, x, g)

    jtest = JaxWindows(jnp.asarray(data), jnp.asarray(grid), initial_step=T0, rollout=1,
                       train=False)
    ttest = WindowedTrajectories(data, grid, initial_step=T0, rollout=1, train=False)
    return params, jax_apply, model, jtest, ttest


def _check(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        for name in NAMES:
            np.testing.assert_allclose(got[k][name], want[k][name], rtol=TOL, atol=1e-7,
                                       err_msg=f"horizon {k} {name}")
        np.testing.assert_allclose(got[k]["mse_time"], want[k]["mse_time"], rtol=TOL)
        assert len(got[k]["mse_time"]) == k


@pytest.mark.parametrize("route", ["module", "fused"])
def test_rollout_study_fused_matches_jax(setup, tmp_path, capsys, route):
    """Five test windows in batches of 2 (a ragged last batch), horizons 1,
    2, 3, 5: the module's forward, or the fused kernels' plain versions on
    the packed tree."""
    params, jax_apply, model, jtest, ttest = setup
    horizons = (1, 2, 3, 5)
    with precision("highest"):
        want = jre.rollout_study_fused(jax_apply, params, jtest, horizons=horizons, batch_size=2,
                                       iLow=1, iHigh=3, out_path=tmp_path / "j.json")
        capsys.readouterr()
        if route == "module":
            fn, p = (lambda x, g: model(x, g)), None
        else:
            fn = functools.partial(tre.fused_fno_apply, modes=MODES)
            p = flax_to_packed(params, MODES, device="cpu")
        got = tre.rollout_study_fused(fn, p, ttest, horizons=horizons, batch_size=2, iLow=1,
                                      iHigh=3, out_path=tmp_path / "t.json", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"rollout {k}" for k in horizons]
    _check(got, want)
    jj, tj = json.loads((tmp_path / "j.json").read_text()), json.loads((tmp_path / "t.json").read_text())
    assert sorted(tj) == sorted(jj) == ["1", "2", "3", "5"]
    assert all(sorted(tj[k]) == sorted(jj[k]) for k in jj)


def test_rollout_study_matches_jax(setup):
    params, jax_apply, model, jtest, ttest = setup
    with precision("highest"):
        want = jre.rollout_study(jax_apply, params, jtest, horizons=(1, 2), batch_size=3,
                                 iLow=1, iHigh=3)
        got = tre.rollout_study(lambda p, x, g: model(x, g), "unused", ttest, horizons=(1, 2),
                                batch_size=3, iLow=1, iHigh=3, device="cpu")
    _check(got, want)


@pytest.mark.parametrize("lite", [False, True])
def test_export_rollout_trajectories_matches_jax(setup, tmp_path, monkeypatch, lite):
    params, jax_apply, model, jtest, ttest = setup
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    with precision("highest"):
        want = jpred.export_rollout_trajectories(jax_apply, params, jtest, steps=3,
                                                 out_dir=tmp_path / "j", prefix="pred",
                                                 batch_size=2)
        got = tpred.export_rollout_trajectories(lambda p, x, g: model(x, g), None, ttest,
                                                steps=3, out_dir=tmp_path / "t", prefix="pred",
                                                batch_size=2, device="cpu")
    assert [p.name for p in got] == [p.name for p in want] == [f"pred_sample{i}.h5"
                                                               for i in range(N)]
    for g, w in zip(got, want):
        with h5py.File(g) as fg, h5py.File(w) as fw:
            assert list(fg.keys()) == list(fw.keys()) == ["data"]
            assert fg["data"].shape == fw["data"].shape == (3, X, X, C)
            assert fw["data"].compression == fg["data"].compression == "lzf"
            assert fg["data"].chunks == fw["data"].chunks
            np.testing.assert_allclose(fg["data"][:], fw["data"][:], rtol=TOL,
                                       atol=TOL * np.abs(fw["data"][:]).max())
