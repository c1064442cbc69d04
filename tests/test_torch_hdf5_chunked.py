"""The port's HDF5 subset (``sciml_pde_torch/io/hdf5_lite.py``) on chunked,
filtered datasets, against h5py and the JAX package's writers.

Reading: every writer of the JAX package (through h5py: chunks, shuffle,
LZF) gives a file the subset reads bit for bit, whole and sliced, with
h5py's ``chunks``, ``compression`` and ``shuffle``; the port's DR and NS
loaders, reading through the subset, give the JAX loaders' windows on one
JAX-written store; deflate reads; any other filter raises and names it.
Writing: each of the port's writers, through the subset, writes the file
it writes through h5py (the same bytes of data, chunk shape and filters:
h5py's own choice for the call), which h5py reads; an index of more than
64 chunks (a B-tree of several levels), a chunk LZF cannot shrink (stored
raw, its mask bit set), chunks never written (not stored; the fill
value), slice-by-slice and repeated writes, and an append to a file that
already holds chunked datasets.  Exact everywhere.
"""

import dataclasses

import h5py
import numpy as np
import pytest
from h5py._hl.filters import guess_chunk as h5py_guess_chunk

from _torch_h5_fixture import LAYOUT, fixture_arrays, write_fixture
from sciml_pde_tpu.data import dr as jdr
from sciml_pde_tpu.data import ns as jns
from sciml_pde_tpu.io import h5 as jh5
from sciml_pde_tpu.sim import burgers_1d as JB
from sciml_pde_tpu.sim import darcy_2d as JD
from sciml_pde_tpu.sim import gen_ns_incomp as jgen
from sciml_pde_tpu.sim import ns_plume_3d as JP
from sciml_pde_tpu.sim import velocity2vorticity as jv2v
from sciml_pde_torch.data import dr as tdr
from sciml_pde_torch.data import ns as tns
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.sim import burgers_1d as TB
from sciml_pde_torch.sim import darcy_2d as TD
from sciml_pde_torch.sim import gen_ns_incomp as tgen
from sciml_pde_torch.sim import ns_incomp_2d as TN
from sciml_pde_torch.sim import ns_plume_3d as TP
from sciml_pde_torch.sim import velocity2vorticity as tv2v


def _smooth(shape, seed: int) -> np.ndarray:
    """A smooth field (LZF shrinks it) with a seeded phase."""
    phase = np.random.default_rng(seed).uniform(0, 6)
    grids = np.meshgrid(*[np.linspace(0, 3, n) for n in shape], indexing="ij")
    return np.sin(sum(grids) + phase).astype(np.float32)


def _datasets(path) -> list:
    names = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
    return names


def _selections(shape) -> list:
    sel = [(0,), (-1,), (Ellipsis, slice(None, None, 2)), (slice(1, None, 3),)]
    if len(shape) > 1:
        sel += [(-1, slice(1, 3)), (slice(None), 0), ([0, shape[0] - 1], Ellipsis, -1)]
    return [s for s in sel if all(n > 2 for n in shape)]


def _check_lite_reads(path) -> None:
    """Every dataset of ``path`` through the subset is h5py's, bit for bit,
    whole and in slices, with h5py's layout; every group's attributes."""
    names = _datasets(path)
    assert names
    with h5py.File(path, "r") as g, hdf5_lite.File(path) as f:
        for name in names:
            a, b = g[name], f[name]
            assert (b.shape, b.dtype, b.chunks, b.compression, b.shuffle) == \
                (a.shape, a.dtype, a.chunks, a.compression, a.shuffle), name
            got, want = b[()], a[()]
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
            for s in _selections(a.shape):
                assert b[s].tobytes() == a[s].tobytes() and b[s].shape == a[s].shape, (name, s)
            parent = name.rpartition("/")[0] or "/"
            assert dict(f[parent].attrs if parent != "/" else f.attrs) == dict(g[parent].attrs)


def _check_same_files(p_h5py, p_lite) -> None:
    """The file the subset wrote is the one h5py wrote for the same calls:
    datasets, bytes, layout and filters, attributes (both read by h5py)."""
    assert _datasets(p_h5py) == _datasets(p_lite)
    with h5py.File(p_h5py, "r") as g, h5py.File(p_lite, "r") as f:
        assert dict(f.attrs) == dict(g.attrs)
        for name in _datasets(p_h5py):
            a, b = g[name], f[name]
            assert (b.shape, b.dtype, b.chunks, b.compression, b.compression_opts, b.shuffle) \
                == (a.shape, a.dtype, a.chunks, a.compression, a.compression_opts, a.shuffle), name
            assert b[()].tobytes() == a[()].tobytes(), name
            assert dict(b.attrs) == dict(a.attrs)


# ------------------------------------------------------------------ reading


def _jax_seed_groups(path):
    x, t = np.linspace(0, 1, 8, dtype=np.float32), np.linspace(0, 1, 6, dtype=np.float32)
    for seed in (3, 4):
        jh5.write_seed_group(path, seed, _smooth((6, 8, 8, 2), seed), x, x, t, "cfg: 1")


def _jax_ns(path):
    jgen.write_ns_h5(path, _smooth((2, 5, 8, 8, 2), 1), _smooth((2, 5, 8, 8, 1), 2),
                     _smooth((2, 8, 8, 2), 3), _smooth((2, 5), 4), {"grid_size": [8, 8]})


def _jax_burgers(path, monkeypatch):
    monkeypatch.setattr(JB, "simulate_burgers",
                        lambda u0, nu, t, nx, nt, sub: _smooth((u0.shape[0], nt, nx), nx))
    JB.generate_burgers_file(path, n_samples=3, nx=32, n_frames=5, t_final=0.2, batch=2)


def _jax_darcy(path, monkeypatch):
    monkeypatch.setattr(JD, "sample_coefficient", lambda k, nb, nx, ny, **kw: _smooth((nb, nx, ny),
                                                                                      nb))
    monkeypatch.setattr(JD, "solve_darcy", lambda a, beta: np.cos(np.asarray(a)))
    JD.generate_darcy_file(path, n_samples=3, nx=16, batch=2)


def _jax_plume(path, monkeypatch):
    cfg = JP.Plume3DConfig(res=(6, 8, 10), out_res=(6, 8, 10), n_frames=3, out_frames=3)
    monkeypatch.setattr(JP, "simulate_plume", lambda key, cfg: (None, None))
    monkeypatch.setattr(JP, "resample_outputs", lambda v, s, cfg: (
        _smooth((*cfg.out_res, cfg.out_frames, 3), 5), _smooth((cfg.out_frames, *cfg.out_res), 6)))
    JP.generate_plume_files(path.parent, 7, cfg, "_interp")
    return path.parent / "v_trj_seed7_interp.h5", path.parent / "s_trj_seed7_interp.h5"


def _cfd_file(path):
    with h5py.File(path, "w") as f:
        for i, k in enumerate(("Vx", "Vy", "Vz")):
            f.create_dataset(k, data=_smooth((3, 2, 8, 6, 4), i))
        for k, n in (("x-coordinate", 8), ("y-coordinate", 6), ("z-coordinate", 4)):
            f.create_dataset(k, data=np.linspace(0, 1, n, endpoint=False).astype(np.float32))
    return path


def _jax_vorticity(path, monkeypatch):
    return jv2v.convert_velocity(_cfd_file(path.with_name("cfd.h5")), batch=2)


@pytest.mark.parametrize("writer", ["seed_groups", "ns", "burgers", "darcy", "plume",
                                    "vorticity"])
def test_lite_reads_jax_writers_files(tmp_path, monkeypatch, writer):
    path = tmp_path / "j.h5"
    out = {"seed_groups": lambda: _jax_seed_groups(path), "ns": lambda: _jax_ns(path),
           "burgers": lambda: _jax_burgers(path, monkeypatch),
           "darcy": lambda: _jax_darcy(path, monkeypatch),
           "plume": lambda: _jax_plume(path, monkeypatch),
           "vorticity": lambda: _jax_vorticity(path, monkeypatch)}[writer]()
    paths = out if isinstance(out, tuple) else (out or path,)
    for p in paths:
        with h5py.File(p, "r") as g:  # each file holds the writers' chunked LZF
            assert any(g[n].compression == "lzf" and g[n].chunks for n in _datasets(p))
        _check_lite_reads(p)


def test_port_loaders_read_a_jax_store_through_lite(tmp_path, monkeypatch):
    """The port's DR and NS loaders through the subset against the JAX
    loaders through h5py, on one JAX-written store: the same data, grid
    and windows."""
    x, t = np.linspace(0, 1, 8, dtype=np.float32), np.linspace(0, 1, 8, dtype=np.float32)
    for seed in range(10):
        jh5.write_seed_group(tmp_path / tdr.PRIMARY_FILE, seed, _smooth((8, 8, 8, 2), seed),
                             x, x, t, "cfg")
    for i in (0, 1, 250):
        jgen.write_ns_h5(tmp_path / f"ns_incom_inhom_2d_256-{i}.h5", _smooth((2, 6, 8, 8, 2), i),
                         _smooth((2, 6, 8, 8, 1), i + 1), _smooth((2, 8, 8, 2), i + 2),
                         np.tile(np.linspace(0, 1, 6, dtype=np.float32), (2, 1)), {})
    monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    kw = dict(train_subsample=9, initial_step=3, rollout_test=2)
    pairs = [(tdr.load_dr_baseline(str(tmp_path), **kw, device="cpu"),
              jdr.load_dr_baseline(str(tmp_path), **kw))]
    kw = dict(train_subsample=2, initial_step=2, rollout_test=1, test_range=(250, 251))
    pairs.append((tns.load_ns_baseline(str(tmp_path), **kw, device="cpu"),
                  jns.load_ns_baseline(str(tmp_path), **kw)))
    for got, want in pairs:
        for split in ("train", "test"):
            g, w = getattr(got, split), getattr(want, split)
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
            np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
            np.testing.assert_array_equal(g.window_index(), w.window_index())


def test_embedded_store_is_jax_writers_output(tmp_path):
    """The store ``chip_smoke.py`` phase 23 reads on the card: JAX's NS writer
    on the fixture's arrays writes it again, and the embedded file reads
    through the subset to those arrays, with its layout and its raw
    (incompressible) chunks."""
    a = fixture_arrays()
    jgen.write_ns_h5(tmp_path / "again.h5", a["velocity"], a["particles"], a["force"], a["t"],
                     {"grid_size": [16, 16], "fixture": True})
    path = write_fixture(tmp_path / "fixture.h5")
    with h5py.File(tmp_path / "again.h5", "r") as g, hdf5_lite.File(path) as f:
        assert sorted(f.keys()) == sorted(g.keys()) == sorted(a)
        assert dict(f.attrs) == dict(g.attrs)
        for k, want in a.items():
            assert g[k][()].tobytes() == f[k][()].tobytes() == want.tobytes(), k
            assert (f[k].chunks, f[k].compression, f[k].shuffle) == LAYOUT[k] == \
                (g[k].chunks, g[k].compression, g[k].shuffle), k
        masks = {k: {m for _, _, m in f[k]._index.values()} for k in a}
        assert masks["force"] == {2} and masks["velocity"] == {0}  # noise stored raw
    _check_lite_reads(path)


def test_lite_reads_deflate(tmp_path):
    data = np.arange(600, dtype=np.float64).reshape(20, 30)
    with h5py.File(tmp_path / "g.h5", "w") as f:
        f.create_dataset("g", data=data, compression="gzip")
        f.create_dataset("gs", data=data.astype(np.int16), compression="gzip",
                         compression_opts=9, shuffle=True, chunks=(7, 30))
    _check_lite_reads(tmp_path / "g.h5")
    with hdf5_lite.File(tmp_path / "g.h5") as f:
        assert [f["g"].compression_opts, f["gs"].compression_opts] == [4, 9]


def test_unsupported_filters_raise_naming_them(tmp_path):
    with h5py.File(tmp_path / "f.h5", "w") as f:
        f.create_dataset("f", data=np.ones((10, 10), np.float32), fletcher32=True)
        f.create_dataset("so", data=np.arange(10, dtype=np.int32), scaleoffset=0)
    with hdf5_lite.File(tmp_path / "f.h5") as f:
        assert f["f"].shape == (10, 10) and f["f"].compression is None
        with pytest.raises(NotImplementedError, match=r"filter 3 \(fletcher32\)"):
            f["f"][0]
        with pytest.raises(NotImplementedError, match=r"filter 6 \(scaleoffset\)"):
            np.asarray(f["so"])
    with hdf5_lite.File(tmp_path / "w.h5", "w") as f:
        with pytest.raises(NotImplementedError, match="writes LZF"):
            f.create_dataset("d", data=np.ones(4), compression="gzip")
        with pytest.raises(ValueError, match="no options"):
            f.create_dataset("d", data=np.ones(4), compression="lzf", compression_opts=1)
        with pytest.raises(TypeError, match="Scalar"):
            f.create_dataset("d", data=np.float32(1), compression="lzf")
        with pytest.raises(ValueError, match="greater than data shape"):
            f.create_dataset("d", data=np.ones(4), chunks=(5,))


# ------------------------------------------------------------------ writing


def _cfd(path):
    return _cfd_file(path / "cfd.h5")


PORT_WRITERS = {
    "seed_groups": lambda d: h5io.write_seed_groups(
        d / "s.h5", {s: _smooth((6, 8, 8, 2), s) for s in (0, 5)},
        *(np.linspace(0, 1, 8, dtype=np.float32),) * 2, np.linspace(0, 1, 6, dtype=np.float32),
        "cfg"),
    "ns": lambda d: tgen.write_ns_h5(d / "ns.h5", _smooth((2, 5, 8, 8, 2), 1),
                                     _smooth((2, 5, 8, 8, 1), 2), _smooth((2, 8, 8, 2), 3),
                                     _smooth((2, 5), 4), {"n": 1}),
    "ns_streamed": lambda d: tgen.generate_ns_file(
        d / "ns.h5", 0, TN.NSIncompConfig(grid_size=(16, 16), dt=1e-3, n_steps=4, frame_int=1,
                                          n_batch=2, nu=0.01), frames_per_chunk=2, device="cpu"),
    "burgers": lambda d: TB.generate_burgers_file(d / "b.h5", n_samples=3, nx=32, n_frames=5,
                                                  t_final=0.2, batch=2, device="cpu"),
    "darcy": lambda d: TD.generate_darcy_file(d / "d.h5", n_samples=3, nx=16, batch=2,
                                              device="cpu"),
    "plume": lambda d: TP.generate_plume_files(d, 2, TP.Plume3DConfig(
        res=(6, 8, 10), out_res=(6, 8, 10), n_frames=2, out_frames=2, substeps=1, dt=1e-3,
        cg_tol=1e-3, cg_max_iter=50), "", device="cpu"),
    "vorticity": lambda d: tv2v.convert_velocity(_cfd(d), batch=2, device="cpu"),
}


@pytest.mark.parametrize("writer", list(PORT_WRITERS))
def test_port_writers_through_lite_write_h5pys_file(tmp_path, monkeypatch, writer):
    (tmp_path / "h").mkdir()
    (tmp_path / "l").mkdir()
    PORT_WRITERS[writer](tmp_path / "h")
    monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    PORT_WRITERS[writer](tmp_path / "l")
    written = sorted(p.name for p in (tmp_path / "h").glob("*.h5") if p.name != "cfd.h5")
    assert written and written == sorted(p.name for p in (tmp_path / "l").glob("*.h5")
                                         if p.name != "cfd.h5")
    for name in written:
        _check_same_files(tmp_path / "h" / name, tmp_path / "l" / name)
        _check_lite_reads(tmp_path / "l" / name)


@pytest.mark.parametrize("shape, itemsize", [((101, 128, 128, 2), 4), ((1, 4), 4), ((7,), 8),
                                             ((50, 50, 89, 150, 3), 4), ((0, 5), 4),
                                             ((3, 2, 8, 6, 4), 4), ((1000, 3), 2)])
def test_guess_chunk_is_h5pys(shape, itemsize):
    assert hdf5_lite.guess_chunk(shape, itemsize) == h5py_guess_chunk(shape, None, itemsize)


def _root_level(path, name) -> int:
    with hdf5_lite.File(path) as f:
        r = f._reader
        layout = next(o for t, o, _ in r.messages(f[name]._addr) if t == 0x08)
        root, = r.u("Q", layout + 3)
        return r.b[root + 5]


def test_deep_chunk_index(tmp_path):
    """More chunks than a node holds (2 x 32), and more than two levels
    hold: the subset's index is a tree of several levels that h5py reads,
    and it reads h5py's."""
    data = np.arange(5000 * 4, dtype=np.float32).reshape(5000, 4)
    with hdf5_lite.File(tmp_path / "l.h5", "w") as f:
        f.create_dataset("d", data=data, chunks=(1, 4), compression="lzf")
        f.create_dataset("e", data=data[:300], chunks=(1, 4))
    with h5py.File(tmp_path / "l.h5") as g:
        assert g["d"].id.get_num_chunks() == 5000 and g["e"].id.get_num_chunks() == 300
        assert g["d"][()].tobytes() == data.tobytes()
        assert g["e"][()].tobytes() == data[:300].tobytes()
        assert g["d"][4321, 2] == data[4321, 2]
    assert _root_level(tmp_path / "l.h5", "d") == 2 and _root_level(tmp_path / "l.h5", "e") == 1
    with h5py.File(tmp_path / "h.h5", "w") as g:
        g.create_dataset("d", data=data[:3000], chunks=(1, 4), compression="lzf")
    assert _root_level(tmp_path / "h.h5", "d") >= 1
    _check_lite_reads(tmp_path / "h.h5")


def test_incompressible_chunk_is_stored_raw(tmp_path):
    """A chunk LZF cannot shrink is stored as it came from the shuffle, with
    LZF's bit (the second filter: 2) of its mask set, as h5py stores it; a
    smooth chunk is compressed, mask 0."""
    noise = np.frombuffer(np.random.default_rng(0).bytes(2048), np.float32).reshape(2, 256).copy()
    noise[1] = np.sin(np.linspace(0, 3, 256))
    for path, mod in ((tmp_path / "l.h5", hdf5_lite), (tmp_path / "h.h5", h5py)):
        with mod.File(path, "w") as f:
            f.create_dataset("n", data=noise, chunks=(1, 256), compression="lzf", shuffle=True)
    with h5py.File(tmp_path / "l.h5") as f, h5py.File(tmp_path / "h.h5") as g:
        raw, smooth = f["n"].id.read_direct_chunk((0, 0)), f["n"].id.read_direct_chunk((1, 0))
        assert raw[0] == g["n"].id.read_direct_chunk((0, 0))[0] == 2
        assert raw[1] == noise[0].view(np.uint8).reshape(256, 4).T.tobytes()  # shuffled only
        assert smooth[0] == 0 and len(smooth[1]) < 1024
        assert f["n"][()].tobytes() == noise.tobytes()


def test_unwritten_chunks_read_as_the_fill_value(tmp_path):
    """Chunks no write touched are not stored and read as the fill value;
    one written in part is stored at close, padded with it; an h5py file's
    own fill value reads through the subset."""
    with hdf5_lite.File(tmp_path / "l.h5", "w") as f:
        d = f.create_dataset("d", (10, 10), "f4", chunks=(3, 4), compression="lzf")
        d[0:3, 0:4] = 1.0  # one whole chunk
        d[4, 5] = 2.0  # part of another
        e = f.create_dataset("e", (6, 6), "f4", chunks=(2, 2), compression="lzf")
    want = np.zeros((10, 10), np.float32)
    want[0:3, 0:4], want[4, 5] = 1.0, 2.0
    with h5py.File(tmp_path / "l.h5") as g:
        assert g["d"].id.get_num_chunks() == 2 and g["e"].id.get_num_chunks() == 0
        assert g["d"][()].tobytes() == want.tobytes() and not g["e"][()].any()
    with hdf5_lite.File(tmp_path / "l.h5") as f:
        assert f["d"][()].tobytes() == want.tobytes() and not f["e"][()].any()
    with h5py.File(tmp_path / "h.h5", "w") as g:
        d = g.create_dataset("d", (10, 10), "f4", chunks=(5, 5), fillvalue=3.5,
                             compression="lzf")
        d[0, 0] = 1.0
    _check_lite_reads(tmp_path / "h.h5")
    with hdf5_lite.File(tmp_path / "h.h5") as f:
        assert f["d"][9, 9] == f["d"][0, 1] == 3.5 and f["d"][0, 0] == 1.0


def test_slice_writes_and_rewrites(tmp_path):
    """Writes slice by slice across chunks (a chunk is stored once every
    element of it is written), a chunk written again (a new copy, the index
    points to it), the selections h5py takes, all as h5py sees them."""
    rng = np.random.default_rng(1)
    want = _smooth((9, 7, 5), 0)
    with hdf5_lite.File(tmp_path / "l.h5", "w") as f:
        d = f.create_dataset("d", want.shape, "f4", compression="lzf", chunks=(2, 3, 5))
        for i in range(9):  # row by row: a chunk spans two rows
            d[i] = want[i]
            if i % 2 == 0 and i < 8:
                assert any(p[0] == i // 2 for p in d._pending)
        assert not d._pending
        stored = len(d._index)
        d[3:5, 1:2] = 7.0
        want[3:5, 1:2] = 7.0
        d[[0, 8], ..., 4] = -1.0
        want[[0, 8], ..., 4] = -1.0
        assert len(d._index) == stored and not d._pending
        for s in [(slice(None, None, 2), 1), (Ellipsis, 0), (-2, [0, 3, 6]), (5, 3, 4),
                  (np.flatnonzero(rng.random(9) > 0.5),)]:
            assert np.array_equal(d[s], want[s]), s
    with h5py.File(tmp_path / "l.h5") as g:
        assert g["d"][()].tobytes() == want.tobytes()
    _check_lite_reads(tmp_path / "l.h5")


def test_lite_appends_to_a_chunked_store(tmp_path):
    """h5py's chunked LZF store, an append through the subset, an append
    through h5py after it: every dataset of each reads through both."""
    path = tmp_path / "s.h5"
    first = {s: _smooth((6, 8, 8, 2), s) for s in (0, 1)}
    grid = (*(np.linspace(0, 1, 8, dtype=np.float32),) * 2, np.linspace(0, 1, 6,
                                                                          dtype=np.float32))
    for s, a in first.items():
        jh5.write_seed_group(path, s, a, *grid, "cfg")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(h5io, "h5py_module", lambda: hdf5_lite)
        h5io.write_seed_groups(path, {2: _smooth((6, 8, 8, 2), 2)}, *grid, "cfg")
    jh5.write_seed_group(path, 3, _smooth((6, 8, 8, 2), 3), *grid, "cfg")
    with h5py.File(path) as g:
        assert sorted(g.keys()) == ["0000", "0001", "0002", "0003"]
        for s in range(4):
            assert g[f"{s:04d}/data"][()].tobytes() == _smooth((6, 8, 8, 2), s).tobytes()
            assert g[f"{s:04d}/data"].compression == "lzf"
    _check_lite_reads(path)


def test_index_forms_match_h5py(tmp_path):
    """The selections the port's readers and writers use, on a chunked and a
    contiguous dataset, through both readers."""
    want = _smooth((5, 6, 7), 9)
    with h5py.File(tmp_path / "h.h5", "w") as g:
        g.create_dataset("c", data=want, chunks=(2, 4, 3), compression="lzf", shuffle=True)
        g.create_dataset("p", data=want)
    sels = [(), (Ellipsis,), (2,), (-1, 3), (slice(1, 4),), (slice(None, None, 2), 1),
            (Ellipsis, slice(1, 6, 3)), ([0, 2, 4],), (np.array([1, 3]), Ellipsis, 6),
            (slice(None), np.flatnonzero(np.arange(6) % 2 == 0)),
            (4, 5, 6), (slice(3, 3),)]
    with h5py.File(tmp_path / "h.h5") as g, hdf5_lite.File(tmp_path / "h.h5") as f:
        for name in ("c", "p"):
            for s in sels:
                a, b = g[name][s], f[name][s]
                assert np.shape(a) == np.shape(b) and np.array_equal(a, b), (name, s)
        with pytest.raises(IndexError):
            f["c"][5]
        with pytest.raises(ValueError):
            f["c"][::-1]

