"""zstd frames (RFC 8878) and CRC-32C, for the JAX package's checkpoints.

``decompress`` calls the C decoder of ``csrc/zstd.c`` (every block and
table type of the format but dictionaries, the XXH64 content checksum
checked where a frame has one), built with the host's C compiler at first
use (``ops/_build.py::load_host``) and bound with ``ctypes``; where the
library cannot be built it raises: nothing falls back.  ``compress``
writes valid zstd that stores its input: one single-segment frame with
the content size and raw blocks of at most 128 KiB (f32 weights shrink
little under zstd's level 1, and every zstd reader takes raw blocks).
``crc32c`` is the Castagnoli CRC of OCDBT's files, from the same library.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "zstd.c"
MAGIC = 0xFD2FB528
MAX_BLOCK = 128 * 1024

_ERRORS = {
    -1: "truncated frame", -2: "not a zstd frame (bad magic)", -3: "bad frame header",
    -4: "the frame needs a dictionary", -5: "bad block (reserved type or over its maximum)",
    -6: "corrupt literals section", -7: "corrupt Huffman table or stream",
    -8: "corrupt FSE table", -9: "corrupt sequences section",
    -10: "a match reaches before the start of the output",
    -11: "the content is larger than its buffer", -12: "the content is not the frame's size",
    -13: "content checksum mismatch", -14: "out of memory",
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built codec (compiled on first use; a failed build raises)."""
    from sciml_pde_torch.ops import _build

    lib = _build.load_host(SOURCE)
    lib.zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.zstd_decompress.restype = ctypes.c_int64
    lib.zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.zstd_content_size.restype = ctypes.c_int64
    lib.zstd_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.zstd_crc32c.restype = ctypes.c_uint32
    return lib


def _u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data if a.size else None


def decompress_array(data, size: int | None = None) -> np.ndarray:
    """The content of every frame of ``data`` as a uint8 array.  ``size`` is
    the expected size where the frame declares none (a zarr chunk's bytes,
    a node's bound); without either the buffer grows until the content
    fits.  ValueError names what is wrong with a corrupt or truncated
    frame."""
    src = _u8(data)
    lib = library()
    declared = lib.zstd_content_size(_ptr(src), src.size) if src.size >= 5 else -1
    bound = (src.size // 4 + 1) * MAX_BLOCK  # a block takes at least 4 bytes
    if declared > bound:
        raise ValueError(f"zstd: the frame declares {declared} bytes, more than it can hold")
    cap = declared if declared >= 0 else (size if size is not None else 4 * src.size + 1024)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.zstd_decompress(out.ctypes.data, cap, _ptr(src), src.size)
        if n == -11 and declared < 0 and cap < bound:
            cap = 2 * cap + MAX_BLOCK
            continue
        if n < 0:
            raise ValueError(f"zstd: {_ERRORS.get(n, f'error {n}')}")
        return out[:n]


def decompress(data, size: int | None = None) -> bytes:
    """``decompress_array`` as bytes."""
    return decompress_array(data, size).tobytes()


def compress(data) -> bytes:
    """One zstd frame that stores ``data``: single segment, the content size
    in the header, raw blocks of at most 128 KiB, no checksum."""
    src = _u8(data)
    n = src.size
    if n < 256:
        head = struct.pack("<IBB", MAGIC, 0x20, n)
    elif n < 65536 + 256:
        head = struct.pack("<IBH", MAGIC, 0x60, n - 256)
    elif n < 1 << 32:
        head = struct.pack("<IBI", MAGIC, 0xA0, n)
    else:
        head = struct.pack("<IBQ", MAGIC, 0xE0, n)
    parts = [head]
    raw = memoryview(np.ascontiguousarray(src))
    starts = list(range(0, n, MAX_BLOCK)) or [0]
    for k, s in enumerate(starts):
        size = min(MAX_BLOCK, n - s)
        last = k == len(starts) - 1
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(raw[s:s + size])
    return b"".join(parts)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    src = _u8(data)
    return int(library().zstd_crc32c(_ptr(src), src.size))

