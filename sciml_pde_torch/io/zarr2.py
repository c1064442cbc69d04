"""zarr v2 arrays in a key-value store, as orbax writes each leaf of a
checkpoint into its OCDBT database.

An array named ``name`` is the key ``{name}/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype`` such as ``<f4`` or ``bfloat16``, ``order`` (C is
read), ``fill_value``, ``compressor``: zstd or null,
``dimension_separator``) and a key per stored chunk, ``{name}/i.j.k``
(``{name}/0`` for a scalar, whose ``chunks`` is ``[]``).  Chunks are whole
even at the edges; a chunk that is not stored holds the fill value (zero
where it is null).

``read_array`` returns a numpy array (``bfloat16`` as its raw ``uint16``
bits, with the dtype name beside it); ``array_items`` gives the keys and
values of one array stored as a single zstd chunk, as orbax stores the
JAX package's arrays.
"""

from __future__ import annotations

import json
import math
from typing import Callable

import numpy as np

from sciml_pde_torch.io import zstd

COMPRESSOR = {"id": "zstd", "level": 1}  # orbax's; the port writes its frames' raw blocks
_KINDS = "fiub"  # float, int, uint, bool


def _numpy_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")
    dt = np.dtype(name)
    if dt.kind not in _KINDS or dt.kind == "f" and dt.itemsize not in (2, 4, 8):
        raise ValueError(f"zarr dtype {name!r} is not one a checkpoint holds")
    return dt


def zarray(shape: tuple, dtype: str) -> bytes:
    """The ``.zarray`` of an array stored as one chunk, as orbax writes it."""
    meta = {"chunks": list(shape), "compressor": COMPRESSOR, "dimension_separator": ".",
            "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def dtype_name(a: np.ndarray) -> str:
    """zarr's name of a numpy dtype (little-endian, as orbax writes it)."""
    dt = a.dtype
    if dt.kind not in _KINDS:
        raise ValueError(f"no zarr dtype for {dt}")
    return "|b1" if dt.kind == "b" else dt.newbyteorder("<").str


def array_items(name: str, data: np.ndarray, dtype: str | None = None) -> dict[str, bytes]:
    """The keys and values of ``data`` as the array ``name``: one chunk of
    the whole, zstd frames of raw blocks.  ``dtype`` names the zarr type
    where it is not numpy's (``bfloat16`` for ``uint16`` bits)."""
    dtype = dtype or dtype_name(data)
    raw = np.ascontiguousarray(data).astype(_numpy_dtype(dtype), copy=False)
    chunk = ".".join("0" for _ in data.shape) or "0"
    return {f"{name}/.zarray": zarray(tuple(data.shape), dtype),
            f"{name}/{chunk}": zstd.compress(raw.reshape(-1).view(np.uint8))}


def read_array(name: str, get: Callable[[str], bytes | None]) -> tuple[np.ndarray, str]:
    """The array ``name`` of a store read through ``get(key) -> bytes | None``:
    (values, zarr dtype name)."""
    raw_meta = get(f"{name}/.zarray")
    if raw_meta is None:
        raise KeyError(f"no zarr array {name!r}")
    meta = json.loads(raw_meta)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, not 2")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} (zstd or none are read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r} (C order is read)")
    dt = _numpy_dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dt.itemsize
    whole = chunks == shape  # one chunk, as orbax stores a checkpoint's arrays
    out = None if whole else np.full(shape, 0 if fill is None else fill, dt)
    for idx in np.ndindex(*grid):
        value = get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if value is None:
            continue
        data = (zstd.decompress_array(value, chunk_bytes) if comp is not None
                else np.frombuffer(value, np.uint8))
        if data.size != chunk_bytes:
            raise ValueError(f"{name}: chunk {idx} holds {data.size} bytes, not {chunk_bytes}")
        block = data.view(dt).reshape(chunks)
        if whole:
            return (block if comp is not None else block.copy()), meta["dtype"]
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:
        out = np.full(shape, 0 if fill is None else fill, dt)
    return out, meta["dtype"]
