"""Port of the DR data generators (``sim/diff_react.py``,
``sim/gen_diff_react.py``, ``sim/downsample_dr.py``, ``io/h5.py``'s writer)
vs the JAX package's, at 16^2 x 21 frames on the CPU.

The ICs come from numpy on both sides, so the trajectories are held to
1e-5 of the largest magnitude (the scratch check reads <= 1e-7).  Files are
compared group by group: keys, grids and the ``config`` attribute exactly,
``data`` within that bound.  Each file is also written by the port's own
HDF5 subset (``io/hdf5_lite.py``), the writer of hosts
without h5py, and must load identically through both packages' loaders.
The subset's appends keep every group the file held, whether h5py wrote
it (LZF) or a write fails, and exclude a second writer.
"""

import contextlib

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import dr as jdr
from sciml_pde_tpu.io import h5 as jh5
from sciml_pde_tpu.sim import diff_react as jsim
from sciml_pde_tpu.sim import downsample_dr as jdown
from sciml_pde_tpu.sim import gen_diff_react as jgen
from sciml_pde_torch.data import dr as tdr
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.sim import diff_react as tsim
from sciml_pde_torch.sim import downsample_dr as tdown
from sciml_pde_torch.sim import gen_diff_react as tgen

TOL = 1e-5
SMALL = dict(xdim=16, ydim=16, tdim=21, t=2.0)
SIM_TYPES = ("all", "react", "diff")


@contextlib.contextmanager
def monkeypatch_lite():
    """The port's HDF5 calls through its own subset, as where h5py is not
    installed."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(h5io, "h5py_module", lambda: hdf5_lite)
        yield


@pytest.fixture
def writer(request, monkeypatch):
    """'h5py', or 'lite': the port writes and reads through its own HDF5
    subset, as where h5py is not installed."""
    if request.param == "lite":
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    return request.param


def _groups(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: {"data": f[k]["data"][:], "attrs": dict(f[k].attrs),
                    **{g: f[k]["grid"][g][:] for g in ("x", "y", "t")},
                    "compression": f[k]["data"].compression}
                for k in f.keys()}


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_initial_condition_and_substeps_are_jax():
    for st in SIM_TYPES:
        jc, tc = jsim.DiffReactConfig(sim_type=st, **SMALL), tsim.DiffReactConfig(sim_type=st,
                                                                                   **SMALL)
        assert tsim.stability_substeps(tc) == jsim.stability_substeps(jc)
        assert tsim.stability_substeps(tsim.DiffReactConfig(sim_type=st)) == \
            jsim.stability_substeps(jsim.DiffReactConfig(sim_type=st))
        np.testing.assert_array_equal(tsim.initial_condition(3, tc), jsim.initial_condition(3, jc))
        for a in ("x", "y", "tgrid"):
            np.testing.assert_array_equal(getattr(tc, a), getattr(jc, a))


@pytest.mark.parametrize("sim_type", SIM_TYPES)
def test_rhs_and_laplacian_match_jax(sim_type):
    cfg = tsim.DiffReactConfig(sim_type=sim_type, **SMALL)
    s = np.random.default_rng(1).normal(size=(2, 16, 16, 2)).astype(np.float32)
    want = jsim._rhs(jnp.asarray(s), jsim.DiffReactConfig(sim_type=sim_type, **SMALL))
    got = tsim._rhs(torch.from_numpy(s), cfg)
    assert _rel(got.numpy(), want) <= TOL
    lap_j = jsim.laplacian_neumann(jnp.asarray(s[..., 0]), 3.0, 5.0)
    lap_t = tsim.laplacian_neumann(torch.from_numpy(s[..., 0]), 3.0, 5.0)
    assert _rel(lap_t.numpy(), lap_j) <= TOL


@pytest.mark.parametrize("writer", ["h5py", "lite"], indirect=True)
@pytest.mark.parametrize("sim_type", SIM_TYPES)
def test_generate_dataset_matches_jax(tmp_path, sim_type, writer):
    """Both packages' ``generate_dataset`` at 3 seeds: the same groups,
    grids and attributes, the trajectories within 1e-5."""
    jgen.generate_dataset(tmp_path / "j.h5", 3, jsim.DiffReactConfig(sim_type=sim_type, **SMALL),
                          seed_start=2, device_batch=2, verbose=False)
    tgen.generate_dataset(tmp_path / "t.h5", 3, tsim.DiffReactConfig(sim_type=sim_type, **SMALL),
                          seed_start=2, device_batch=2, verbose=False, device="cpu")
    want, got = _groups(tmp_path / "j.h5"), _groups(tmp_path / "t.h5")
    assert sorted(got) == sorted(want) == ["0002", "0003", "0004"]
    for k in want:
        assert got[k]["data"].shape == want[k]["data"].shape == (21, 16, 16, 2)
        assert got[k]["data"].dtype == np.float32
        assert _rel(got[k]["data"], want[k]["data"]) <= TOL, k
        for g in ("x", "y", "t"):
            np.testing.assert_array_equal(got[k][g], want[k][g])
        assert got[k]["attrs"] == want[k]["attrs"]
        # LZF through either writer (the subset writes h5py's chunked LZF)
        assert want[k]["compression"] == got[k]["compression"] == "lzf"


@pytest.mark.parametrize("writer", ["h5py", "lite"], indirect=True)
def test_generate_dataset_resumes(tmp_path, capsys, writer):
    """A re-run skips the seed groups the file holds and adds the rest."""
    cfg = tsim.DiffReactConfig(**SMALL)
    tgen.generate_dataset(tmp_path / "r.h5", 2, cfg, verbose=False, device="cpu")
    with h5py.File(tmp_path / "r.h5") as f:
        first = f["0001"]["data"][:]
    tgen.generate_dataset(tmp_path / "r.h5", 4, cfg, verbose=True, device="cpu")
    assert "resume: skipping 2 seeds" in capsys.readouterr().out
    with h5py.File(tmp_path / "r.h5") as f:
        assert sorted(f.keys()) == ["0000", "0001", "0002", "0003"]
        np.testing.assert_array_equal(f["0001"]["data"][:], first)


@pytest.mark.parametrize("writer", ["h5py", "lite"], indirect=True)
def test_downsample_file_matches_jax_exactly(tmp_path, writer):
    # the source through the port's writer: the subset reads what it wrote
    tgen.generate_dataset(tmp_path / "src.h5", 2, tsim.DiffReactConfig(sim_type="diff", **SMALL),
                          verbose=False, device="cpu")
    n_j = jdown.downsample_file(tmp_path / "src.h5", tmp_path / "j.h5", 9, 12, verbose=False)
    n_t = tdown.downsample_file(tmp_path / "src.h5", tmp_path / "t.h5", 9, 12, verbose=False)
    assert n_j == n_t == 2
    want, got = _groups(tmp_path / "j.h5"), _groups(tmp_path / "t.h5")
    for k in want:
        assert got[k]["data"].shape == (9, 12, 12, 2)
        for name in ("data", "x", "y", "t"):
            np.testing.assert_array_equal(got[k][name], want[k][name])
        assert got[k]["attrs"] == want[k]["attrs"]
    with pytest.raises(FileExistsError):
        tdown.downsample_file(tmp_path / "src.h5", tmp_path / "t.h5", 9, 12, verbose=False)
    a = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdown._resize_linear_axis(a, 1, 4),
                                  jdown._resize_linear_axis(a, 1, 4))


@pytest.mark.parametrize("writer", ["h5py", "lite"], indirect=True)
def test_port_written_store_loads_identically(tmp_path, writer):
    """A port-written DR store (10 seeds, the 90/10 split) through the port's
    loader (through the file's own writer) and JAX's (through h5py)."""
    tgen.generate_dataset(tmp_path / tdr.PRIMARY_FILE, 10, tsim.DiffReactConfig(**SMALL),
                          verbose=False, device="cpu")
    got = tdr.load_dr_baseline(str(tmp_path), train_subsample=9, initial_step=5,
                               rollout_test=2, device="cpu")
    want = jdr.load_dr_baseline(str(tmp_path), train_subsample=9, initial_step=5,
                                rollout_test=2)
    # and the other way: a JAX-written (h5py, LZF) store through the port's
    # loader, which reads it through either reader
    jgen.generate_dataset(tmp_path / "j" / tdr.PRIMARY_FILE, 10, jsim.DiffReactConfig(**SMALL),
                          verbose=False)
    want_j = jdr.load_dr_baseline(str(tmp_path / "j"), train_subsample=9, initial_step=5,
                                  rollout_test=2)
    got_j = tdr.load_dr_baseline(str(tmp_path / "j"), train_subsample=9, initial_step=5,
                                 rollout_test=2, device="cpu")
    for split in ("train", "test"):
        np.testing.assert_array_equal(getattr(got_j, split).data.numpy(),
                                      np.asarray(getattr(want_j, split).data))
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
        np.testing.assert_array_equal(g.window_index(), w.window_index())


def _h5py_store(path, seeds) -> dict:
    """A store as the JAX package writes it (h5py, LZF): {seed: data}."""
    rng = np.random.default_rng(4)
    out = {s: rng.normal(size=(5, 4, 4, 2)).astype(np.float32) for s in seeds}
    for s, a in out.items():
        jh5.write_seed_group(path, s, a, *(np.arange(4, dtype=np.float32),) * 2,
                             np.arange(5, dtype=np.float32), "cfg")
    return out


def _check_store(path, want: dict):
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == [f"{s:04d}" for s in sorted(want)]
        for s, a in want.items():
            np.testing.assert_array_equal(f[f"{s:04d}"]["data"][:], a)
            assert f[f"{s:04d}"].attrs["config"] == "cfg"


@pytest.mark.parametrize("n_new", [4, 300])
def test_lite_appends_to_h5py_lzf_store(tmp_path, n_new):
    """The subset's append to an h5py-written LZF store, in batches of 8 as
    the generator writes: every earlier group stays, h5py reads the new
    ones (300 groups: a root B-tree of two levels), and h5py appends after
    it.  A batch that raises mid-session commits nothing and loses nothing."""
    path = tmp_path / "s.h5"
    want = _h5py_store(path, range(3))
    rng = np.random.default_rng(5)
    grid = (np.arange(4, dtype=np.float32),) * 2 + (np.arange(5, dtype=np.float32),)
    with monkeypatch_lite():
        for b in range(3, 3 + n_new, 8):
            batch = {s: rng.normal(size=(5, 4, 4, 2)).astype(np.float32)
                     for s in range(b, min(b + 8, 3 + n_new))}
            h5io.write_seed_groups(path, batch, *grid, "cfg")
            want.update(batch)
        _check_store(path, want)
        with pytest.raises(RuntimeError, match="killed"):
            with hdf5_lite.File(path, "a") as f:
                h5io.create_seed_group(f, 9000, want[3], *grid, "cfg")
                raise RuntimeError("killed mid-batch")
        _check_store(path, want)
    want.update(_h5py_store(path, [9001]))
    _check_store(path, want)


def test_lite_write_excludes_a_second_writer(tmp_path):
    """A session open for writing holds the file's lock: a second writer,
    the subset's or h5py's, gets an OSError (which write_seed_groups
    retries), and gets the file once the first closes."""
    path = tmp_path / "s.h5"
    want = _h5py_store(path, range(2))
    grid = (np.arange(4, dtype=np.float32),) * 2 + (np.arange(5, dtype=np.float32),)
    first = hdf5_lite.File(path, "a")
    h5io.create_seed_group(first, 2, want[0], *grid, "cfg")
    with pytest.raises(OSError):
        hdf5_lite.File(path, "a")
    with pytest.raises(OSError):
        h5py.File(path, "a")
    with monkeypatch_lite(), pytest.raises(OSError):
        h5io.write_seed_groups(path, {3: want[1]}, *grid, "cfg", max_retries=2)
    first.close()
    with monkeypatch_lite():
        h5io.write_seed_groups(path, {3: want[1]}, *grid, "cfg", max_retries=2)
    _check_store(path, {**want, 2: want[0], 3: want[1]})


_WRITER = """
import importlib.util, sys
import numpy as np
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
lite = load("hdf5_lite", sys.argv[1] + "/hdf5_lite.py")
h5io = load("h5io", sys.argv[1] + "/h5.py")
h5io.h5py_module = lambda: lite
path, first = sys.argv[2], int(sys.argv[3])
grid = (np.arange(4, dtype=np.float32),) * 2 + (np.arange(5, dtype=np.float32),)
for b in range(3):
    seeds = (first + 2 * b, first + 2 * b + 1)
    h5io.write_seed_groups(path, {s: np.full((5, 4, 4, 2), s, np.float32) for s in seeds},
                           *grid, "cfg", max_retries=600)
"""


def test_lite_concurrent_writers_lose_no_group(tmp_path):
    """More writers than cores, each appending three batches of two seed
    groups to one file through the subset (write_seed_groups retrying while
    another holds the lock): no group is lost, none is torn."""
    import os
    import subprocess
    import sys

    io_dir = os.path.dirname(hdf5_lite.__file__)
    path = tmp_path / "s.h5"
    n = (os.cpu_count() or 4) + 2
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, io_dir, str(path), str(6 * i)])
             for i in range(n)]
    try:
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            p.kill()
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == [f"{s:04d}" for s in range(6 * n)]
        for k in f.keys():
            assert (f[k]["data"][:] == int(k)).all() and f[k].attrs["config"] == "cfg"
