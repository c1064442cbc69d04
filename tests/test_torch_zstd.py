"""The port's zstd decoder (``sciml_pde_torch/io/csrc/zstd.c``, bound by
``io/zstd.py``) against the ``zstandard`` package: frames of levels 1, 3
and 19 with and without a content checksum, with and without the content
size, on data that takes every block and table type (raw, RLE and
compressed blocks; raw, RLE and Huffman literals in 1 and 4 streams; FSE,
predefined, RLE and repeated sequence tables); empty input, RLE-only
input, inputs over 128 KiB and over a small window; the port's own frames
(raw blocks) read by ``zstandard``; and corrupt and truncated frames
raising (a checksum mismatch among them).  Also CRC-32C on its check value, and the
frames embedded for ``chip_smoke.py`` phase 24a."""

import hashlib

import numpy as np
import pytest

from sciml_pde_torch.io import zstd

zs = pytest.importorskip("zstandard")

from _torch_orbax_fixture import ZSTD_FRAMES, zstd_contents  # noqa: E402


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    text = b"the quick brown fox jumps over the lazy dog; " * 4000
    return {
        "text": text,
        "f32_noise": rng.normal(size=50_000).astype(np.float32).tobytes(),
        "f32_small": np.ones(5, np.float32).tobytes(),
        "i64_ramp": np.arange(40_000, dtype=np.int64).tobytes(),
        "two_symbols": bytes(rng.integers(0, 2, size=300_000, dtype=np.uint8)),
        "zipf": bytes((rng.zipf(1.4, size=250_000) % 256).astype(np.uint8)),
        "smooth": np.sin(np.linspace(0, 200, 70_000)).astype(np.float32).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_matches_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = zs.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("name", ["text", "f32_noise", "zipf"])
def test_frames_without_content_size(name):
    """A stream's frames (no content size, a window descriptor) and a
    size hint that is too small both decode: the buffer grows."""
    data = INPUTS[name]
    c = zs.ZstdCompressor(level=3).compressobj()
    frame = c.compress(data) + c.flush()
    assert zs.get_frame_parameters(frame).content_size == zs.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, size=100) == data


def test_empty_and_rle_only():
    for data in (b"", b"\x07" * 400_000, b"\x00"):
        frame = zs.ZstdCompressor(level=3, write_checksum=True).compress(data)
        assert zstd.decompress(frame) == data
    # RLE blocks alone: 300000 bytes in three blocks of 4 bytes each
    rle = (b"\x28\xb5\x2f\xfd" + bytes([0xA0]) + (300_000).to_bytes(4, "little")
           + ((131072 << 3) | 2).to_bytes(3, "little") + b"\x41"
           + ((131072 << 3) | 2).to_bytes(3, "little") + b"\x42"
           + (((300_000 - 262144) << 3) | 3).to_bytes(3, "little") + b"\x43")
    assert zstd.decompress(rle) == b"A" * 131072 + b"B" * 131072 + b"C" * (300_000 - 262144)


def test_over_the_window():
    """A 1 KiB window: matches stay within it across many blocks, and the
    repeat offsets and tables carry from block to block."""
    rng = np.random.default_rng(1)
    data = b"".join(bytes(rng.integers(0, 8, 700, dtype=np.uint8)) * 3 for _ in range(200))
    params = zs.ZstdCompressionParameters.from_level(19, window_log=10)
    frame = zs.ZstdCompressor(compression_params=params).compress(data)
    assert len(data) > 128 * 1024 and zstd.decompress(frame) == data


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 128 * 1024, 300_001])
def test_writer_frames_read_by_zstandard(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    frame = zstd.compress(data)
    assert zs.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    assert zs.get_frame_parameters(frame).content_size == n


def test_corrupt_and_truncated_frames_raise():
    data = INPUTS["zipf"]
    frame = zs.ZstdCompressor(level=19, write_checksum=True).compress(data)
    for cut in (0, 3, 4, 6, 20, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(frame[:cut])
    bad = bytearray(frame)
    bad[0] ^= 1
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(bytes(bad))
    bad = bytearray(frame)
    bad[-1] ^= 0x10  # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    bad = bytearray(frame)
    bad[4] |= 0x08  # the header's reserved bit
    with pytest.raises(ValueError, match="header"):
        zstd.decompress(bytes(bad))
    # bits flipped anywhere: the decoder raises or returns, never reads or
    # writes out of bounds; with the checksum it never returns wrong data
    rng = np.random.default_rng(2)
    for _ in range(300):
        bad = bytearray(frame)
        bad[rng.integers(5, len(bad))] ^= 1 << int(rng.integers(0, 8))
        try:
            assert zstd.decompress(bytes(bad), size=len(data)) == data
        except ValueError:
            pass


def test_crc32c_matches_its_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


def test_embedded_frames_decode_to_their_contents():
    """The frames ``chip_smoke.py`` phase 24a decodes on the card: what
    ``zstandard`` makes of each content again, and the decoder's output."""
    contents = zstd_contents()
    assert any(len(c) > 128 * 1024 for c in contents.values())
    for name, level, checksum, digest, frame in ZSTD_FRAMES:
        data = contents[name]
        assert hashlib.sha256(data).hexdigest() == digest
        assert zstd.decompress(frame) == data, (name, level, checksum)
        assert zs.ZstdDecompressor().decompress(frame) == data


def test_failed_build_raises(tmp_path, monkeypatch):
    """A decoder the compiler refuses raises with the compiler's words, and
    so does a checkpoint read that needs it: nothing falls back."""
    from sciml_pde_torch.utils.checkpoint import restore_params, save_checkpoint

    save_checkpoint(tmp_path / "ck", {"w": np.ones(4, np.float32)}, [None], 0, 0.5)
    bad = tmp_path / "zstd.c"
    bad.write_text("long zstd_decompress(void) { return }\n")
    monkeypatch.setattr(zstd, "SOURCE", bad)
    zstd.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="zstd.c failed"):
            zstd.decompress(zs.ZstdCompressor().compress(b"abc"))
        with pytest.raises(RuntimeError, match="failed"):
            restore_params(tmp_path / "ck")
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()
    assert restore_params(tmp_path / "ck")[1] == 0.5
