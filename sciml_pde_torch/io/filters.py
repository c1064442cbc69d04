"""The HDF5 filter pipeline of the port's HDF5 subset (``io/hdf5_lite.py``).

A chunked dataset names its filters in order; a chunk is written through
them in that order and read back through them in reverse.  Each chunk
carries a filter mask: bit ``i`` set means filter ``i`` was skipped for
that chunk (an optional filter that failed, as LZF does on a chunk it
cannot shrink, leaving the chunk stored raw).

Filters taken: shuffle (id 2, the byte transpose by element size, both
ways), LZF (id 32000, ``io/lzf.py``, both ways) and deflate (id 1, zlib,
reading only: no writer of either package asks for it).  Any other
(fletcher32, szip, n-bit, scale-offset, ...) raises NotImplementedError
naming its id.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from sciml_pde_torch.io import lzf

DEFLATE, SHUFFLE, SZIP, LZF = 1, 2, 4, 32000
NAMES = {DEFLATE: "deflate", SHUFFLE: "shuffle", 3: "fletcher32", SZIP: "szip", 5: "nbit",
         6: "scaleoffset", LZF: "lzf"}
OPTIONAL = 1  # the flag of a filter a chunk may skip
LZF_VERSION, LZF_FILTER_REVISION = 0x0105, 4  # h5py's client data: (4, 261, chunk bytes)


@dataclass(frozen=True)
class Filter:
    """One entry of a dataset's filter pipeline message."""

    id: int
    flags: int = OPTIONAL
    cd: tuple[int, ...] = ()
    name: str = ""

    @property
    def label(self) -> str:
        return self.name or NAMES.get(self.id, "unknown")


def shuffle(buf, itemsize: int) -> np.ndarray:
    """The bytes of each element's position gathered: all first bytes, then
    all second bytes, ...  A tail shorter than one element stays last."""
    b = np.frombuffer(buf, np.uint8)
    n = b.size // itemsize
    if itemsize <= 1 or n <= 1:
        return b
    return np.concatenate([b[: n * itemsize].reshape(n, itemsize).T.reshape(-1),
                           b[n * itemsize :]])


def unshuffle(buf, itemsize: int) -> np.ndarray:
    b = np.frombuffer(buf, np.uint8)
    n = b.size // itemsize
    if itemsize <= 1 or n <= 1:
        return b
    return np.concatenate([b[: n * itemsize].reshape(itemsize, n).T.reshape(-1),
                           b[n * itemsize :]])


def _unsupported(f: Filter, what: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5 filter {f.id} ({f.label}): this subset {what} shuffle, "
                               "LZF" + (" and deflate" if what == "reads" else ""))


def decode(data, pipeline, mask: int, nbytes: int):
    """A chunk's stored bytes -> its ``nbytes`` bytes of data."""
    for i in reversed(range(len(pipeline))):
        f = pipeline[i]
        if mask >> i & 1:
            continue
        if f.id == SHUFFLE:
            data = unshuffle(data, f.cd[0])
        elif f.id == LZF:
            data = lzf.decompress(data, nbytes)
        elif f.id == DEFLATE:
            data = zlib.decompress(data)
        else:
            raise _unsupported(f, "reads")
    if len(data) != nbytes:
        raise OSError(f"a chunk decodes to {len(data)} bytes, not {nbytes}")
    return data


def encode(data, pipeline) -> tuple[bytes, int]:
    """A chunk's bytes -> (the bytes to store, its filter mask)."""
    mask = 0
    for i, f in enumerate(pipeline):
        if f.id == SHUFFLE:
            data = shuffle(data, f.cd[0])
        elif f.id == LZF:
            out = lzf.compress(data)
            if out is not None:
                data = out
            elif f.flags & OPTIONAL:
                mask |= 1 << i  # stored as it came: LZF could not shrink it
            else:
                raise OSError("LZF could not shrink a chunk, and the filter is not optional")
        else:
            raise _unsupported(f, "writes")
    return bytes(data), mask
