"""LZF, the codec of HDF5's filter 32000 (h5py's ``compression="lzf"``).

``compress`` and ``decompress`` call the C codec of ``csrc/lzf.c``, built
with the host's C compiler at first use (``ops/_build.py::load_host``) and
bound with ``ctypes``; it is host code, as h5py's filter is.  Where the
library cannot be built they raise: nothing falls back to the Python
codec.  ``lzf_compress_plain`` and ``lzf_decompress_plain`` are that codec
step for step in Python (the same stream, byte for byte), for the tests
and ``chip_smoke.py``'s comparison only.

The stream format (``csrc/lzf.c`` has it in full): a control byte below 32
is a literal run of that many plus one bytes; any other is a
back-reference of ``(c >> 5)`` (plus the next byte when that is 7) plus 2
bytes, from ``((c & 31) << 8)`` plus the following byte plus 1 back.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "lzf.c"
HASH_LOG, MAX_LIT, MAX_OFF, MAX_REF = 14, 32, 8192, 264  # as in csrc/lzf.c


@functools.cache
def library() -> ctypes.CDLL:
    """The built codec (compiled on first use; a failed build raises)."""
    from sciml_pde_torch.ops import _build

    lib = _build.load_host(SOURCE)
    for fn in (lib.lzf_encode, lib.lzf_decode):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else \
        np.ascontiguousarray(data).reshape(-1).view(np.uint8)


def compress(data, limit: int | None = None) -> bytes | None:
    """The LZF stream of ``data`` (any contiguous buffer), or None where it
    would take more than ``limit`` bytes (default: one less than the input,
    so a stream is always shorter than what it encodes) or the input is
    empty."""
    src = _u8(data)
    limit = src.size - 1 if limit is None else limit
    if src.size == 0 or limit <= 0:
        return None
    out = np.empty(limit, np.uint8)
    n = library().lzf_encode(src.ctypes.data, src.size, out.ctypes.data, limit)
    return out[:n].tobytes() if n else None


def decompress(data, size: int) -> bytearray:
    """The ``size`` bytes the LZF stream ``data`` encodes; ValueError where
    the stream is not valid or does not decode to exactly ``size`` bytes."""
    src = _u8(data)
    out = bytearray(size)
    dst = (ctypes.c_char * size).from_buffer(out) if size else None
    n = library().lzf_decode(src.ctypes.data, src.size, ctypes.addressof(dst) if size else None,
                             size)
    if n == -1:
        raise ValueError(f"LZF stream decodes to more than {size} bytes")
    if n < 0:
        raise ValueError("not a valid LZF stream")
    if n != size:
        raise ValueError(f"LZF stream decodes to {n} bytes, not {size}")
    return out


def _hash3(b: bytes, i: int) -> int:
    v = (b[i] << 16) | (b[i + 1] << 8) | b[i + 2]
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def lzf_compress_plain(data, limit: int | None = None) -> bytes | None:
    """``compress`` in Python: the same greedy encoder, the same bytes."""
    b = _u8(data).tobytes()
    n = len(b)
    limit = n - 1 if limit is None else limit
    if n == 0 or limit <= 0:
        return None
    out = bytearray()

    def literals(start: int, end: int) -> None:
        for s in range(start, end, MAX_LIT):
            run = b[s : min(s + MAX_LIT, end)]
            out.append(len(run) - 1)
            out.extend(run)

    table: dict[int, int] = {}
    ip = lit = 0
    while ip + 2 < n:
        h = _hash3(b, ip)
        ref = table.get(h, -1)
        table[h] = ip
        if ref >= 0 and ip - ref <= MAX_OFF and b[ref : ref + 3] == b[ip : ip + 3]:
            max_len = min(n - ip, MAX_REF)
            length = 3
            while length < max_len and b[ref + length] == b[ip + length]:
                length += 1
            literals(lit, ip)
            off, code = ip - ref - 1, length - 2
            if code < 7:
                out.append((code << 5) | (off >> 8))
            else:
                out += bytes([(7 << 5) | (off >> 8), code - 7])
            out.append(off & 0xFF)
            if len(out) > limit:
                return None
            for k in range(ip + 1, min(ip + length, n - 2)):
                table[_hash3(b, k)] = k
            ip += length
            lit = ip
        else:
            ip += 1
    literals(lit, n)
    return bytes(out) if len(out) <= limit else None


def lzf_decompress_plain(data, size: int) -> bytearray:
    """``decompress`` in Python."""
    b = _u8(data).tobytes()
    out = bytearray()
    ip = 0
    while ip < len(b):
        c = b[ip]
        ip += 1
        if c < 32:
            if ip + c + 1 > len(b):
                raise ValueError("not a valid LZF stream")
            out += b[ip : ip + c + 1]
            ip += c + 1
        else:
            length = c >> 5
            if length == 7:
                if ip >= len(b):
                    raise ValueError("not a valid LZF stream")
                length += b[ip]
                ip += 1
            if ip >= len(b):
                raise ValueError("not a valid LZF stream")
            ref = len(out) - ((c & 31) << 8) - 1 - b[ip]
            ip += 1
            if ref < 0:
                raise ValueError("not a valid LZF stream")
            for k in range(length + 2):
                out.append(out[ref + k])
        if len(out) > size:
            raise ValueError(f"LZF stream decodes to more than {size} bytes")
    if len(out) != size:
        raise ValueError(f"LZF stream decodes to {len(out)} bytes, not {size}")
    return out
