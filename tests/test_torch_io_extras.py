"""The port's I/O extras against the JAX package's: ``data/generic.py``
(``HDF5Dataset``, ``HDF5DataModule``) on the same files, read through h5py
and through the port's own HDF5 subset with h5py blocked, every item and
batch equal bit for bit; ``utils/profiling.py``'s ``trace`` (a Chrome
trace written) and ``StepTimer`` (JAX's warm-up rule); ``utils/export.py``
(the NS production FNO and a 3-step rollout exported, saved, loaded and
run: equal to the module's output, tolerance 1e-6 of its largest
magnitude; a function that launches a hand-written kernel refused); and
``utils/upload.py::dataverse_upload``'s command list equal to JAX's, dry
runs only."""

import sys

import h5py
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import generic as jgeneric
from sciml_pde_tpu.utils import profiling as jprof
from sciml_pde_tpu.utils.upload import dataverse_upload as jax_upload
from sciml_pde_torch.data import generic
from sciml_pde_torch.utils import export, profiling
from sciml_pde_torch.utils.upload import dataverse_upload


@pytest.fixture(scope="module")
def h5_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("generic")
    rng = np.random.default_rng(0)
    for i, n in enumerate((3, 4)):
        with h5py.File(d / f"part{i}.h5", "w") as f:
            f.create_dataset("u", data=rng.normal(size=(n, 5, 6)).astype(np.float32))
            f.create_dataset("nu", data=rng.uniform(size=(n, 2)))
    (d / "notes.txt").write_text("not hdf5")
    return d


@pytest.mark.parametrize("with_h5py", [True, False], ids=["h5py", "subset"])
def test_hdf5_dataset_and_module_match_jax(h5_folder, monkeypatch, with_h5py):
    splits = ("train", "val", "test")
    jds = jgeneric.HDF5Dataset(h5_folder)
    want = [jds[i] for i in range(len(jds))]
    jdm = jgeneric.HDF5DataModule(h5_folder, batch_size=2, splits=(0.5, 0.25, 0.25))
    want_b = {s: list(jdm.iter_split(s)) for s in splits}
    if not with_h5py:
        monkeypatch.setitem(sys.modules, "h5py", None)
    got = generic.HDF5Dataset(h5_folder)
    got_dm = generic.HDF5DataModule(h5_folder, batch_size=2, splits=(0.5, 0.25, 0.25))
    assert len(got) == len(want) == 7
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])
    for split in splits:
        gb, wb = list(got_dm.iter_split(split)), want_b[split]
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(FileNotFoundError):
        generic.HDF5Dataset(h5_folder, pattern="*.nc")
    with pytest.raises(ValueError, match="splits must be"):
        generic.HDF5DataModule(h5_folder, splits=(1.0, 0.0))


def test_trace_and_step_timer(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        torch.ones(64).cumsum(0)
    assert list((tmp_path / "tr").glob("*.pt.trace.json"))
    got, want = profiling.StepTimer(warmup=2), jprof.StepTimer(warmup=2)
    for t in (got, want):
        assert np.isnan(t.steps_per_sec)
        t.tick()
        t.tick()
        assert np.isnan(t.steps_per_sec) and t.t0 is not None
        t.tick()
        assert t.steps_per_sec > 0
    assert got.count == want.count == 3


def test_export_round_trip_of_the_production_fno(tmp_path):
    from sciml_pde_torch.eval.rollout import rollout_predict
    from sciml_pde_torch.train.fno_train import make_fno

    model = make_fno(3, 4, 8, 4, generator=torch.Generator().manual_seed(0)).eval()
    x, g = torch.randn(2, 16, 16, 4, 3), torch.randn(2, 16, 16, 2)
    for name, fn in (("step", lambda a, b: model(a, b)),
                     ("rollout", lambda a, b: rollout_predict(lambda u, v: model(u, v), a, b,
                                                              3))):
        art = export.export_apply(fn, (x, g), platforms=("tpu", "cpu"))
        serve = export.load_exported(export.save_exported(art, tmp_path / f"{name}.pt2"))
        with torch.no_grad():
            want = fn(x, g)
            got = serve(x, g)
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    with pytest.raises(ValueError, match="not among the platforms"):
        export.export_apply(fn, (x, g), platforms=("tpu",))


def test_export_refuses_a_kernel(monkeypatch):
    """A function whose call counts a kernel launch is refused by name."""
    from sciml_pde_torch.ops import attention

    def launches(a):
        attention.LAUNCHES["attention_fwd"] += 1
        return a * 2

    with pytest.raises(RuntimeError, match="attention_fwd.*torch.library"):
        export.export_apply(launches, (torch.ones(3),))


@pytest.mark.parametrize("folder", [None, "runs/a"])
def test_dataverse_command_matches_jax(folder):
    args = ("data/f.h5", "https://dv.example", "TOKEN", "doi:10/x")
    got = dataverse_upload(*args, dataverse_dir=folder, retry=3, dry_run=True)
    assert got == jax_upload(*args, dataverse_dir=folder, retry=3, dry_run=True)
    assert got[0] == "curl" and got[-2:] == ["--retry", "3"]
