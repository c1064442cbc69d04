"""The LZF codec of the port's HDF5 subset (``sciml_pde_torch/io/lzf.py``,
``io/csrc/lzf.c``) against its plain Python version and against the
chunks h5py's LZF filter writes.

The C codec and the Python one are the same greedy encoder, so they agree
byte for byte both ways; every stream decodes to its input exactly; a
chunk h5py compressed decodes (after unshuffling) to h5py's own array.
Exact everywhere.  A codec that cannot be built raises, and so does the
LZF dataset that needed it: nothing falls back to the Python codec.
"""

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sciml_pde_torch.io import filters, hdf5_lite, lzf
from sciml_pde_torch.ops import _build


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    smooth = np.sin(np.linspace(0, 40, 6000)).astype(np.float32)
    return {
        "empty": b"",
        "one byte": b"\x07",
        "two bytes": b"ab",
        "three bytes": b"abc",
        "incompressible": rng.bytes(3000),
        "long run": bytes(70_000),
        "run of one byte after a literal": b"x" + b"y" * 1000,
        "overlapping back-references": b"abcab" * 400,
        "literal run of 32": rng.bytes(32) + bytes(40),
        "literal run of 33": rng.bytes(33) + bytes(40),
        "literal runs of 64": rng.bytes(64) * 3,
        "match of 264 and more": b"q" + rng.bytes(300) + b"q" + bytes(600),
        "repeat past the offset window": (rng.bytes(5000) * 2)[:9000] + rng.bytes(9000) * 2,
        "smooth floats": smooth.tobytes(),
        "shuffled smooth floats": filters.shuffle(smooth.tobytes(), 4).tobytes(),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_c_codec_matches_plain_both_ways(name):
    data = _inputs()[name]
    limit = len(data) + len(data) // 16 + 64  # room for any stream of these inputs
    c = lzf.compress(data, limit)
    plain = lzf.lzf_compress_plain(data, limit)
    assert c == plain
    if not data:
        assert c is None
        return
    assert bytes(lzf.decompress(c, len(data))) == data
    assert bytes(lzf.lzf_decompress_plain(c, len(data))) == data
    # the default limit: a stream only where it is shorter than its input
    short = lzf.compress(data)
    assert short == lzf.lzf_compress_plain(data)
    assert (short is None) == (len(c) >= len(data))


def test_codec_refuses_bad_streams():
    good = lzf.compress(b"abcab" * 400)
    for fn in (lzf.decompress, lzf.lzf_decompress_plain):
        with pytest.raises(ValueError, match="more than"):
            fn(good, 1999)
        with pytest.raises(ValueError, match="decodes to"):
            fn(good, 2001)
        with pytest.raises(ValueError, match="not a valid"):
            fn(b"\x20\x05", 10)  # a back-reference before the start
        with pytest.raises(ValueError, match="not a valid"):
            fn(b"\x05abc", 10)  # a literal run cut short


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.binary(max_size=2048), st.integers(1, 6))
def test_round_trip(data, period):
    """Any bytes, and the same made periodic (repeats to find)."""
    for d in (data, (data[:period] * 200)[: 4 * len(data)]):
        big = len(d) + len(d) // 16 + 64
        c = lzf.compress(d, big)
        assert c == lzf.lzf_compress_plain(d, big)
        if d:
            assert bytes(lzf.decompress(c, len(d))) == d
            assert bytes(lzf.lzf_decompress_plain(c, len(d))) == d


def test_decodes_h5py_chunks(tmp_path):
    """Raw chunks h5py's LZF filter wrote (``read_direct_chunk``), decoded
    by both codecs and unshuffled, are h5py's array chunk by chunk; a chunk
    LZF could not shrink is stored raw with LZF's mask bit set."""
    rng = np.random.default_rng(3)
    x = np.linspace(0, 6, 64)
    smooth = (np.sin(x[:, None] * np.arange(1, 5))[None] * np.ones((3, 1, 1))).astype(np.float32)
    noise = rng.normal(size=(3, 64, 4)).astype(np.float32)
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("s", data=smooth, compression="lzf", shuffle=True, chunks=(1, 64, 4))
        f.create_dataset("n", data=noise, compression="lzf", chunks=(1, 64, 4))
    with h5py.File(tmp_path / "c.h5") as f:
        for name, lzf_bit, want_raw in (("s", 2, False), ("n", 1, True)):
            ds = f[name]
            for i in range(3):
                mask, raw = ds.id.read_direct_chunk((i, 0, 0))
                assert bool(mask & lzf_bit) == want_raw
                want = ds[i : i + 1]
                if want_raw:
                    got = [raw]
                else:
                    got = [lzf.decompress(raw, want.nbytes),
                           lzf.lzf_decompress_plain(raw, want.nbytes)]
                for b in got:
                    if ds.shuffle:
                        b = filters.unshuffle(b, 4)
                    np.testing.assert_array_equal(np.frombuffer(b, np.float32).reshape(want.shape),
                                                  want)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with the compiler's words, and
    so do the codec and an LZF dataset that needed it."""
    bad = tmp_path / "lzf.c"
    bad.write_text("int lzf_encode(void) { return }\n")
    with pytest.raises(RuntimeError, match="lzf.c failed"):
        _build.load_host(bad)
    monkeypatch.setattr(lzf, "SOURCE", bad)
    lzf.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            lzf.compress(b"abc" * 100)
        with pytest.raises(RuntimeError, match="failed"):
            with hdf5_lite.File(tmp_path / "x.h5", "w") as f:
                f.create_dataset("d", data=np.zeros(100, np.float32), compression="lzf")
        with hdf5_lite.File(tmp_path / "x.h5") as f:  # the session committed nothing
            assert list(f.keys()) == []
    finally:
        monkeypatch.undo()
        lzf.library.cache_clear()
    assert lzf.compress(b"abc" * 100) is not None
