"""A subset of HDF5 in Python and numpy, for hosts without h5py.

``io/h5.py::h5py_module`` hands this module out where h5py is not
installed.  It offers the calls of h5py that the port makes (``File``,
``Group``, ``Dataset``, ``attrs``, ``create_dataset``, slicing) on files of
the HDF5 1.8 "earliest" format that h5py writes by default: a version 0/1
superblock, version 1 object headers, groups as symbol tables (v1 B-tree,
local heap, symbol nodes) and attributes (numbers, arrays, variable-length
UTF-8 strings in a global heap).

Datasets are contiguous, or chunked as h5py lays them out: a version 3
layout message of class 2 (the chunk's dimensions, then the element size),
its chunks indexed by a version 1 B-tree of node type 1 at any depth (a key
holds a chunk's stored size, filter mask and offset; a node at most
2 x 32 entries), a filter pipeline message and a fill value message.  The
filters are ``io/filters.py``'s: shuffle and LZF both ways (the C codec of
``io/csrc/lzf.c``), deflate for reading; any other raises
NotImplementedError naming it.  ``create_dataset`` takes h5py's
``compression="lzf"``, ``chunks`` and ``shuffle`` and writes what h5py
writes for the same call, with h5py's own chunk shape where ``chunks`` is
not given (``guess_chunk``).  So a file of either writer reads through
either, bit for bit.  Reading decodes only the chunks a selection touches;
a chunk never written is not stored and reads as the fill value.

Writing only appends.  A contiguous dataset's bytes go to the end of the
file when it is created, and ``__setitem__`` writes them through a memory
map.  A chunked dataset buffers each chunk in memory until every element
of it has been written, then filters it and appends it (a chunk written
again gets a new copy, and the index points to the last); ``close()``
appends the chunks written in part, padded with the fill value.  Closing
appends the new objects' headers, their chunk indexes and a new root
group, syncs, and then rewrites the superblock to point at that root: the
one write in place.  Until then the file holds its previous tree, so a
session that raises, or a process killed mid-write, loses nothing the
file held, and an append costs its own bytes, not the file's.  A session
that raises commits nothing.  Objects the file already held are
read-only; new members are added to the root group and to groups created
in the session.

A file open for writing holds an exclusive ``flock``, one open for reading
a shared one, as HDF5's own file locking does: a second writer gets
``BlockingIOError`` (an ``OSError``), which ``io/h5.py::write_seed_groups``
retries.
"""

from __future__ import annotations

import fcntl
import itertools
import math
import mmap
import os
import struct

import numpy as np

from sciml_pde_torch.io import filters
from sciml_pde_torch.io.filters import Filter

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIG = b"\x89HDF\r\n\x1a\n"
_LEAF_K, _NODE_K = 4, 16  # HDF5's default symbol-node and group B-tree K
_ISTORE_K = 32  # HDF5's default chunk B-tree K (a version 0 superblock has no field for it)
# h5py's guess_chunk: a chunk of about CHUNK_BASE x 2^log10(dataset MiB) bytes,
# within [CHUNK_MIN, CHUNK_MAX]
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


def _pwrite(fd: int, data, at: int) -> None:
    view = memoryview(data).cast("B")
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], at + done)


def guess_chunk(shape: tuple, itemsize: int) -> tuple:
    """The chunk shape h5py gives a dataset created with a filter and no
    ``chunks`` (``h5py._hl.filters.guess_chunk``, ported): halve the axes in
    turn, first to last, until the chunk is below the target size or
    within half of it, and below CHUNK_MAX."""
    chunks = np.array([n if n else 1024 for n in shape], dtype="=f8")
    if chunks.size == 0:
        raise ValueError("Chunks not allowed for scalar datasets.")
    target = CHUNK_BASE * 2 ** np.log10(np.prod(chunks) * itemsize / (1024.0 * 1024))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        nbytes = np.prod(chunks) * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and nbytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % chunks.size] = np.ceil(chunks[idx % chunks.size] / 2.0)
        idx += 1
    return tuple(int(c) for c in chunks)


def _storage(shape: tuple, itemsize: int, compression, compression_opts, chunks, shuffle):
    """(chunk shape or None, filter pipeline) of h5py's ``create_dataset``
    arguments, with h5py's refusals."""
    if compression is None and compression_opts is not None:
        raise TypeError("Compression method must be specified")
    if compression not in (None, "lzf"):
        raise NotImplementedError(f"writing compression={compression!r}: this subset writes LZF "
                                  "(and reads deflate)")
    if compression == "lzf" and compression_opts is not None:
        raise ValueError("LZF compression filter accepts no options")
    if chunks is False and (compression or shuffle):
        raise ValueError("Chunked format required for given storage options")
    if not (chunks or compression or shuffle):
        return None, ()
    if shape == ():
        raise TypeError("Scalar datasets don't support chunk/filter options")
    if chunks is None or chunks is True:
        chunks = guess_chunk(shape, itemsize)
    else:
        chunks = tuple(int(c) for c in chunks)
        if len(chunks) != len(shape):
            raise ValueError('"chunks" must have same rank as dataset shape')
        if any(c > n for c, n in zip(chunks, shape)) or min(chunks) < 1:
            raise ValueError("Chunk shape must not be greater than data shape in any "
                             f"dimension. {chunks} is not compatible with {shape}")
    pipeline = []
    if shuffle:
        pipeline.append(Filter(filters.SHUFFLE, filters.OPTIONAL, (itemsize,), "shuffle"))
    if compression == "lzf":
        pipeline.append(Filter(filters.LZF, filters.OPTIONAL, (
            filters.LZF_FILTER_REVISION, filters.LZF_VERSION, math.prod(chunks) * itemsize),
            "lzf"))
    return chunks, tuple(pipeline)


def _pipeline_message(pipeline) -> bytes:
    """Filter pipeline message, version 1 (h5py's)."""
    out = struct.pack("<BB6x", 1, len(pipeline))
    for f in pipeline:
        name = _padded(f.label.encode() + b"\0")
        out += struct.pack("<HHHH", f.id, len(name), f.flags, len(f.cd)) + name
        out += struct.pack(f"<{len(f.cd)}I", *f.cd) + b"\0" * (4 * (len(f.cd) % 2))
    return out


# --------------------------------------------------------------------------
# selections
# --------------------------------------------------------------------------


def _selection(idx, shape: tuple) -> tuple[list, tuple]:
    """h5py's index forms (integers, slices of positive step, Ellipsis, a
    list or 1-D integer array on an axis) -> (the positions taken on each
    axis, the result's shape: integer axes dropped)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    ell = [j for j, i in enumerate(idx) if i is Ellipsis]
    if len(ell) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if ell:
        idx = idx[: ell[0]] + (slice(None),) * (len(shape) - len(idx) + 1) + idx[ell[0] + 1 :]
    if len(idx) > len(shape):
        raise IndexError(f"too many indices ({len(idx)}) for a dataset of rank {len(shape)}")
    idx = idx + (slice(None),) * (len(shape) - len(idx))
    sel, out = [], []
    for i, n in zip(idx, shape):
        if isinstance(i, slice):
            start, stop, step = i.indices(n)
            if step < 1:
                raise ValueError("Step must be >= 1 (got %d)" % step)
            sel.append(np.arange(start, stop, step))
            out.append(len(sel[-1]))
        elif isinstance(i, (int, np.integer)):
            j = int(i) + (n if i < 0 else 0)
            if not 0 <= j < n:
                raise IndexError(f"index {int(i)} out of range for an axis of {n}")
            sel.append(np.array([j]))
        else:
            a = np.asarray(i)
            if a.ndim != 1 or a.dtype.kind not in "iu":
                raise TypeError(f"index {i!r}: this subset takes integers, slices, Ellipsis and "
                                "1-D integer arrays")
            a = np.where(a < 0, a + n, a).astype(np.int64)
            if a.size and (a.min() < 0 or a.max() >= n):
                raise IndexError(f"an index out of range for an axis of {n}")
            sel.append(a)
            out.append(a.size)
    return sel, tuple(out)


def _as_index(pos: np.ndarray):
    """A slice where the positions are evenly spaced and increasing, else
    the positions."""
    if len(pos) == 1 or (len(pos) > 1 and (d := pos[1] - pos[0]) > 0
                         and np.all(np.diff(pos) == d)):
        step = int(pos[1] - pos[0]) if len(pos) > 1 else 1
        return slice(int(pos[0]), int(pos[-1]) + 1, step)
    return pos


def _ix(parts: list):
    """The index of a block: basic where every axis is a slice, else open
    mesh (``np.ix_``) arrays."""
    if all(isinstance(p, slice) for p in parts):
        return tuple(parts)
    return np.ix_(*[np.arange(p.start, p.stop, p.step) if isinstance(p, slice) else p
                    for p in parts])


# --------------------------------------------------------------------------
# datatypes
# --------------------------------------------------------------------------

_VLEN_STR = "vlen-str"


def _parse_dtype(b, o: int):
    """Datatype message at ``o`` -> numpy dtype, or _VLEN_STR."""
    cls = b[o] & 0x0F
    bits = b[o + 1] | (b[o + 2] << 8) | (b[o + 3] << 16)
    size = struct.unpack_from("<I", b, o + 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:  # floating-point
        return np.dtype(f"{order}f{size}")
    if cls == 3:  # fixed-length string
        return np.dtype(f"S{size}")
    if cls == 9 and (bits & 0x0F) == 1:  # variable-length string
        return _VLEN_STR
    raise NotImplementedError(f"HDF5 datatype class {cls} (bits {bits:#x})")


def _dtype_message(dt) -> bytes:
    """Datatype message (version 1) for a numpy dtype or _VLEN_STR."""
    if dt == _VLEN_STR:
        # class 9, string, null-terminated, UTF-8; base type: unsigned 8-bit
        base = bytes([0x10, 0x00, 0x00, 0x00]) + struct.pack("<IHH", 1, 0, 8)
        return bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16) + base
    dt = np.dtype(dt)
    if dt.kind == "f":
        exp = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[dt.itemsize]
        bits = bytes([0x20, dt.itemsize * 8 - 1, 0x00])
        props = struct.pack("<HHBBBBI", 0, dt.itemsize * 8, exp[0], exp[1], 0, exp[2], exp[3])
        return bytes([0x11]) + bits + struct.pack("<I", dt.itemsize) + props
    if dt.kind in "iu":
        bits = bytes([0x08 if dt.kind == "i" else 0x00, 0x00, 0x00])
        return (bytes([0x10]) + bits + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, dt.itemsize * 8))
    if dt.kind == "S":
        return bytes([0x13, 0x00, 0x00, 0x00]) + struct.pack("<I", dt.itemsize)
    raise NotImplementedError(f"writing dtype {dt}")


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------


class _Reader:
    """The metadata of a file, read through a memory map of it."""

    def __init__(self, fd: int, path):
        try:
            self.b = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
        except ValueError:  # an empty file
            raise OSError(f"{path}: not an HDF5 file") from None
        b = self.b
        if b[:8] != _SIG:
            self.close()
            raise OSError(f"{path}: not an HDF5 file (or one past this subset)")
        ver = b[8]
        if ver not in (0, 1) or b[13] != 8 or b[14] != 8:
            self.close()
            raise NotImplementedError(f"{path}: superblock version {ver}, offsets {b[13]}")
        self.leaf_k, self.node_k = self.u("HH", 16)
        self.istore_k = self.u("H", 24)[0] if ver == 1 else _ISTORE_K
        o = 24 + (4 if ver == 1 else 0)  # version 1 adds the indexed-storage K
        base, _, self.eoa = self.u("QQQ", o)
        if base != 0:
            self.close()
            raise NotImplementedError(f"{path}: base address {base}")
        self.sb_size = o + 72
        self.root_header, = self.u("Q", o + 40)
        self._gheap = {}

    def close(self):
        self.b.close()

    def u(self, fmt, o):
        return struct.unpack_from("<" + fmt, self.b, o)

    def messages(self, addr):
        """(type, data offset, size) of every message of a v1 object header,
        continuation blocks followed."""
        b = self.b
        if b[addr] != 1:
            raise NotImplementedError(f"object header version {b[addr]} at {addr}")
        n_msgs, = self.u("H", addr + 2)
        size, = self.u("I", addr + 8)
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            o = start
            while o + 8 <= start + length and len(out) < n_msgs:
                mtype, msize = self.u("HH", o)
                out.append((mtype, o + 8, msize))
                if mtype == 0x10:
                    blocks.append(self.u("QQ", o + 8))
                o += 8 + msize
        return out

    def local_heap_name(self, heap, off):
        data, = self.u("Q", heap + 24)
        start = data + off
        return self.b[start : self.b.find(b"\0", start)].decode()

    def group_links(self, btree, heap) -> dict[str, int]:
        """name -> object header address, over a v1 group B-tree."""
        b, out = self.b, {}
        if b[btree : btree + 4] != b"TREE":
            raise OSError("bad group B-tree")
        level, n = b[btree + 5], self.u("H", btree + 6)[0]
        for i in range(n):
            child, = self.u("Q", btree + 24 + 8 + i * 16)
            if level > 0:
                out.update(self.group_links(child, heap))
                continue
            if b[child : child + 4] != b"SNOD":
                raise OSError("bad symbol table node")
            for j in range(self.u("H", child + 6)[0]):
                e = child + 8 + 40 * j
                name_off, obj = self.u("QQ", e)
                out[self.local_heap_name(heap, name_off)] = obj
        return out

    def vlen_string(self, o):
        length, coll, idx = self.u("IQI", o)
        if coll not in self._gheap:
            objs, b = {}, self.b
            if b[coll : coll + 4] != b"GCOL":
                raise OSError("bad global heap collection")
            csize, = self.u("Q", coll + 8)
            p = coll + 16
            while p + 16 <= coll + csize:
                oi, _, _, osize = self.u("HHIQ", p)
                if oi == 0:
                    break
                objs[oi] = b[p + 16 : p + 16 + osize]
                p += 16 + _pad8(osize)
            self._gheap[coll] = objs
        return self._gheap[coll][idx][:length].decode("utf-8")

    def dataspace(self, o):
        ver, rank = self.b[o], self.b[o + 1]
        start = o + (8 if ver == 1 else 4)
        return tuple(self.u(f"{rank}Q", start)) if rank else ()

    def attribute(self, o):
        b = self.b
        ver = b[o]
        name_len, dt_len, ds_len = self.u("HHH", o + 2)
        p = o + 8 + (1 if ver == 3 else 0)
        pad = _pad8 if ver == 1 else (lambda n: n)
        name = b[p : p + name_len - 1].decode()
        p += pad(name_len)
        dt = _parse_dtype(b, p)
        p += pad(dt_len)
        shape = self.dataspace(p)
        p += pad(ds_len)
        n = int(np.prod(shape)) if shape else 1
        if dt == _VLEN_STR:
            vals = [self.vlen_string(p + 16 * i) for i in range(n)]
            return name, vals[0] if not shape else np.array(vals, dtype=object).reshape(shape)
        arr = np.frombuffer(b, dt, n, p).copy()
        return name, arr.reshape(shape) if shape else arr[0]

    def pipeline(self, o) -> tuple:
        """Filter pipeline message (version 1, or 2) -> its filters."""
        b, out = self.b, []
        ver, n = b[o], b[o + 1]
        if ver not in (1, 2):
            raise NotImplementedError(f"filter pipeline message version {ver}")
        p = o + (8 if ver == 1 else 2)
        for _ in range(n):
            fid, = self.u("H", p)
            p += 2
            name_len = 0
            if ver == 1 or fid >= 256:
                name_len, = self.u("H", p)
                p += 2
            flags, ncd = self.u("HH", p)
            p += 4
            name = bytes(b[p : p + name_len]).split(b"\0")[0].decode(errors="replace")
            p += name_len  # padded to 8 in version 1 already
            cd = self.u(f"{ncd}I", p)
            p += 4 * (ncd + (ncd % 2 if ver == 1 else 0))
            out.append(Filter(fid, flags, cd, name))
        return tuple(out)

    def fill_value(self, mtype, o) -> bytes:
        """The bytes of a fill value message (new 0x05, versions 1-3, or old
        0x04); empty where it defines none (the default: zeros)."""
        b = self.b
        if mtype == 0x04:
            at = o
        elif b[o] in (1, 2):
            at = o + 4 if b[o] == 1 or b[o + 3] else None
        elif b[o] == 3:
            at = o + 2 if b[o + 1] & 0x20 else None
        else:
            raise NotImplementedError(f"fill value message version {b[o]}")
        if at is None:
            return b""
        size, = self.u("I", at)
        return bytes(b[at + 4 : at + 4 + size])

    def chunk_index(self, addr, chunks) -> dict:
        """{chunk position on the chunk grid: (address, stored bytes, filter
        mask)} over the v1 B-tree (node type 1) at ``addr``, at any depth."""
        out, b = {}, self.b
        nd = len(chunks) + 1
        key = 8 + 8 * nd
        todo = [] if addr == UNDEF else [addr]
        while todo:
            a = todo.pop()
            if b[a : a + 4] != b"TREE" or b[a + 4] != 1:
                raise OSError(f"bad chunk B-tree node at {a}")
            level, n = b[a + 5], self.u("H", a + 6)[0]
            for i in range(n):
                k = a + 24 + i * (key + 8)
                child, = self.u("Q", k + key)
                if level:
                    todo.append(child)
                    continue
                size, mask = self.u("II", k)
                offs = self.u(f"{nd - 1}Q", k + 8)
                out[tuple(x // c for x, c in zip(offs, chunks))] = (child, size, mask)
        return out

    def node(self, addr):
        """The object at ``addr``: ('group', links, attrs) or ('dataset', its
        keyword arguments for Dataset, attrs)."""
        attrs, info, links, fill = {}, {}, None, {}
        for mtype, o, _ in self.messages(addr):
            if mtype == 0x11:
                links = self.group_links(*self.u("QQ", o))
            elif mtype == 0x0C:
                k, v = self.attribute(o)
                attrs[k] = v
            elif mtype == 0x01:
                info["shape"] = self.dataspace(o)
            elif mtype == 0x03:
                info["dtype"] = _parse_dtype(self.b, o)
            elif mtype == 0x0B:
                info["pipeline"] = self.pipeline(o)
            elif mtype in (0x04, 0x05):
                fill[mtype] = self.fill_value(mtype, o)
            elif mtype == 0x08:
                ver, cls = self.b[o], self.b[o + 1]
                if ver == 3 and cls == 1:
                    info["data_at"], = self.u("Q", o + 2)
                elif ver == 3 and cls == 2:
                    nd = self.b[o + 2]
                    info["chunks"] = self.u(f"{nd - 1}I", o + 11)
                    info["index"], = self.u("Q", o + 3)
                else:
                    raise NotImplementedError(
                        f"a dataset of layout class {cls} (version {ver}): this subset reads "
                        "contiguous and chunked ones (layout version 3)")
            elif mtype in (0x02, 0x06, 0x0A):
                raise NotImplementedError("new-style (link message) groups")
        if links is not None:
            return "group", links, attrs
        if "chunks" in info:
            info["index"] = self.chunk_index(info["index"], info["chunks"])
        value = fill.get(0x05) or fill.get(0x04, b"")
        if len(value) == info["dtype"].itemsize:
            info["fill"] = np.frombuffer(value, info["dtype"])[0]
        return "dataset", info, attrs


# --------------------------------------------------------------------------
# the h5py-like object model
# --------------------------------------------------------------------------


class AttributeManager(dict):
    """``obj.attrs``: a dict; strings are stored as variable-length UTF-8.
    Those of an object the file already held are read-only."""

    read_only = False

    def __setitem__(self, key, value):
        if self.read_only:
            raise NotImplementedError("attributes of an object the file held are read-only "
                                      "in this subset")
        super().__setitem__(key, value)


class Dataset:
    """A dataset: contiguous (``chunks`` None, read and written through a
    memory map) or chunked (``chunks`` its chunk shape, filtered through
    ``pipeline``)."""

    def __init__(self, file, shape, dtype, writable: bool, data_at: int = UNDEF, chunks=None,
                 pipeline=(), index=None, fill=0):
        self.file = file
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.attrs = AttributeManager()
        self._addr = None  # object header address, for an object the file held
        self._writable = writable
        self._data_at = data_at
        self.chunks = None if chunks is None else tuple(int(c) for c in chunks)
        self._pipeline = tuple(pipeline)
        if self.chunks is not None:
            self._index = dict(index or {})  # chunk grid position -> (address, size, mask)
            self._pending = {}  # position -> (its buffer, its elements not yet written)
            self._fill = np.array(fill, self.dtype)
            return
        n = math.prod(self.shape)
        if n == 0 or data_at == UNDEF:
            self._mm = np.zeros(self.shape, self.dtype)
        else:
            self._mm = np.memmap(file.filename, self.dtype, "r+" if writable else "r",
                                 offset=data_at, shape=(n,)).reshape(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _ids(self) -> set:
        return {f.id for f in self._pipeline}

    @property
    def compression(self):
        ids = self._ids()
        return ("lzf" if filters.LZF in ids else "gzip" if filters.DEFLATE in ids
                else "szip" if filters.SZIP in ids else None)

    @property
    def compression_opts(self):
        return next((f.cd[0] for f in self._pipeline if f.id == filters.DEFLATE and f.cd), None)

    @property
    def shuffle(self) -> bool:
        return filters.SHUFFLE in self._ids()

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self[...], dtype=dtype)

    def __getitem__(self, idx):
        if self.chunks is None:
            return np.array(self._mm[idx])
        sel, shape = _selection(idx, self.shape)
        out = np.empty([len(s) for s in sel], self.dtype)
        for pos, o, i, _ in self._blocks(sel):
            out[o] = self._chunk(pos)[i]
        return out.reshape(shape)[()]

    def __setitem__(self, idx, value):
        self.file._check_writable()
        if self.chunks is None:
            self._mm[idx] = value
            return
        if not self._writable:
            raise ValueError("a dataset the file held is read-only in this subset")
        sel, shape = _selection(idx, self.shape)
        value = np.broadcast_to(np.asarray(value, self.dtype), shape).reshape(
            [len(s) for s in sel])
        for pos, o, i, whole in self._blocks(sel):
            if whole:
                self._pending.pop(pos, None)
                buf, todo = np.full(self.chunks, self._fill), None
            else:
                buf, todo = self._pending.get(pos) or self._open(pos)
            buf[i] = value[o]
            if todo is not None:
                todo[i] = False
                if todo.any():
                    self._pending[pos] = (buf, todo)
                    continue
            self._store(pos, buf)

    def _blocks(self, sel):
        """(chunk grid position, the block's index in the selection, its
        index in the chunk, whether it is all of the chunk's part of the
        dataset) of each chunk the selection touches."""
        axes = []
        for s, c, n in zip(sel, self.chunks, self.shape):
            k = s // c
            if len(s) > 1 and np.all(np.diff(s) > 0):
                groups = np.split(np.arange(len(s)), np.flatnonzero(np.diff(k)) + 1)
            else:
                groups = [np.flatnonzero(k == u) for u in np.unique(k)]
            axis = []
            for g in groups:
                if len(g):
                    u = int(k[g[0]])
                    inner = s[g] - u * c
                    whole = len(inner) == min(c, n - u * c) and inner[0] == 0 \
                        and bool(np.all(np.diff(inner) == 1))
                    axis.append((u, _as_index(g), _as_index(inner), whole))
            axes.append(axis)
        for parts in itertools.product(*axes):
            yield (tuple(p[0] for p in parts), _ix([p[1] for p in parts]),
                   _ix([p[2] for p in parts]), all(p[3] for p in parts))

    def _chunk(self, pos) -> np.ndarray:
        """The chunk at grid position ``pos``, decoded (read-only)."""
        if pos in self._pending:
            return self._pending[pos][0]
        if pos not in self._index:
            return np.full(self.chunks, self._fill)
        addr, size, mask = self._index[pos]
        raw = os.pread(self.file._fd, size, addr)
        if len(raw) != size:
            raise OSError(f"{self.file.filename}: a chunk runs past the end of the file")
        data = filters.decode(raw, self._pipeline, mask,
                              math.prod(self.chunks) * self.dtype.itemsize)
        return np.frombuffer(data, self.dtype).reshape(self.chunks)

    def _open(self, pos):
        """A chunk to write into: a copy of the stored one (complete: it is
        stored again at once), or the fill value with every element of the
        dataset in it still to write."""
        if pos in self._index:
            return self._chunk(pos).copy(), None
        todo = np.zeros(self.chunks, bool)
        todo[tuple(slice(0, min(c, n - p * c)) for p, c, n in
                   zip(pos, self.chunks, self.shape))] = True
        return np.full(self.chunks, self._fill), todo

    def _store(self, pos, buf) -> None:
        data, mask = filters.encode(buf, self._pipeline)
        self._index[pos] = (self.file._append(data), len(data), mask)
        self._pending.pop(pos, None)

    def _store_pending(self) -> None:
        for pos in sorted(self._pending):
            self._store(pos, self._pending[pos][0])


class Group:
    def __init__(self, file):
        self.file = file if file is not None else self
        self._children: dict = {}  # name -> object, or the header address of one not read yet
        self._addr = None  # object header address, for a group the file held
        self.attrs = AttributeManager()

    def _child(self, name: str):
        c = self._children[name]
        if isinstance(c, int):
            c = self._children[name] = self.file._load(c)
        return c

    def _walk(self, name: str, create: bool = False):
        parts = [p for p in name.split("/") if p]
        g = self
        for p in parts[:-1]:
            if p not in g._children:
                if not create:
                    raise KeyError(name)
                g._add(p, Group(self.file))
            g = g._child(p)
        return g, parts[-1]

    def _add(self, name: str, obj):
        if name in self._children:
            raise ValueError(f"{name} already exists")
        if self._addr is not None:
            raise NotImplementedError(f"adding {name!r} to a group the file held: this subset "
                                      "adds to the root and to new groups only")
        self._children[name] = obj

    def __getitem__(self, name: str):
        g, last = self._walk(name)
        if last not in g._children:
            raise KeyError(name)
        return g._child(last)

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def keys(self):
        return sorted(self._children)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._children)

    def create_group(self, name: str) -> "Group":
        self.file._check_writable()
        g, last = self._walk(name, create=True)
        g._add(last, Group(self.file))
        return g._children[last]

    def create_dataset(self, name: str, shape=None, dtype=None, data=None, compression=None,
                       compression_opts=None, chunks=None, shuffle=False):
        """h5py's call: contiguous without a filter or ``chunks``, else
        chunked (``chunks``, or h5py's guess), shuffled where ``shuffle``,
        LZF where ``compression="lzf"``."""
        self.file._check_writable()
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            shape = data.shape if shape is None else shape
        shape = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)
        dt = np.dtype(dtype if dtype is not None else (data.dtype if data is not None else "f4"))
        chunks, pipeline = _storage(shape, dt.itemsize, compression, compression_opts, chunks,
                                    shuffle)
        g, last = self._walk(name, create=True)
        ds = self.file._new_dataset(shape, dt.newbyteorder("<"), chunks, pipeline)
        g._add(last, ds)
        if data is not None:
            ds[...] = data.reshape(ds.shape)
        return ds


class File(Group):
    def __init__(self, path, mode: str = "r"):
        super().__init__(None)
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: this subset takes r, w, a")
        self.filename, self.mode = os.fspath(path), mode
        self._open, self._reader, self._new = False, None, []
        new = mode == "w" or (mode == "a" and not os.path.exists(path))
        self._fd = os.open(path, os.O_RDONLY if mode == "r" else os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(self._fd, (fcntl.LOCK_SH if mode == "r" else fcntl.LOCK_EX)
                        | fcntl.LOCK_NB)
            if new:
                os.ftruncate(self._fd, 0)
                self._sb = bytearray(_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack(
                    "<HHI", _LEAF_K, _NODE_K, 0) + struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF)
                    + bytes(40))
                self._leaf_k, self._node_k, self._eoa = _LEAF_K, _NODE_K, len(self._sb)
                self._istore_k = _ISTORE_K
                self._commit()  # an empty file, whatever becomes of the session
            else:
                r = self._reader = _Reader(self._fd, path)
                self._sb = bytearray(r.b[: r.sb_size])
                self._leaf_k, self._node_k, self._eoa = r.leaf_k, r.node_k, _pad8(r.eoa)
                self._istore_k = r.istore_k
                _, links, attrs = r.node(r.root_header)
                self._children.update(links)
                self.attrs.update(attrs)
                self.attrs.read_only = mode == "r"
        except BaseException:
            self._release()
            raise
        self._open = True

    def _load(self, addr: int):
        kind, info, attrs = self._reader.node(addr)
        if kind == "group":
            obj = Group(self)
            obj._children.update(info)
        else:
            obj = Dataset(self, writable=False, **info)
        obj._addr = addr
        obj.attrs.update(attrs)
        obj.attrs.read_only = True
        return obj

    def _new_dataset(self, shape, dt, chunks=None, pipeline=()) -> Dataset:
        nbytes = math.prod(shape) * dt.itemsize
        data_at = UNDEF
        if nbytes and chunks is None:
            data_at, self._eoa = self._eoa, _pad8(self._eoa + nbytes)
            if os.fstat(self._fd).st_size < self._eoa:
                os.ftruncate(self._fd, self._eoa)
        ds = Dataset(self, shape, dt, True, data_at, chunks, pipeline)
        self._new.append(ds)
        return ds

    def _append(self, data) -> int:
        """Write ``data`` at the end of the file: its address."""
        addr = self._eoa
        _pwrite(self._fd, data, addr)
        self._eoa = _pad8(addr + len(data))
        return addr

    def _check_writable(self):
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")

    def _commit(self):
        """Append the new objects and a new root group, then point the
        superblock at them."""
        for ds in self._new:
            if ds.chunks is not None:
                ds._store_pending()
            elif isinstance(ds._mm, np.memmap):
                ds._mm.flush()
        w = _Writer(self, self._eoa)
        root_header, btree, heap = w.group(self)
        _pwrite(self._fd, w.buf, self._eoa)
        self._eoa += len(w.buf)
        os.fsync(self._fd)
        o = len(self._sb) - 72  # base address, free space, end of file, driver info, root entry
        struct.pack_into("<Q", self._sb, o + 16, self._eoa)
        struct.pack_into("<QQIIQQ", self._sb, o + 32, 0, root_header, 1, 0, btree, heap)
        _pwrite(self._fd, self._sb, 0)
        os.fsync(self._fd)

    def _release(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self._fd is not None:
            os.close(self._fd)  # and with it the lock
            self._fd = None

    def close(self, commit: bool = True):
        if not self._open:
            return
        self._open = False
        try:
            if commit and self.mode != "r":
                self._commit()
        finally:
            self._release()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.close(commit=exc_type is None)


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------


class _Writer:
    """Lays out the objects created in a session, and a root group that
    lists them beside the ones the file held, as bytes to append at
    ``base``."""

    def __init__(self, f: File, base: int):
        self.f, self.base = f, base
        self.buf = bytearray()
        self.strings: list[bytes] = []  # global heap objects, index = position + 1
        self.gheap_at = None
        self._collect_strings(f)
        if self.strings:
            body = b"".join(struct.pack("<HHIQ", i, 1, 0, len(s)) + _padded(s)
                            for i, s in enumerate(self.strings, start=1))
            size = max(4096, 16 + len(body) + 16)
            body += struct.pack("<HHIQ", 0, 0, 0, size - 16 - len(body))  # the free space
            coll = b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body
            self.gheap_at = self.alloc(coll + b"\0" * (size - len(coll)))

    def alloc(self, data: bytes) -> int:
        addr = self.base + len(self.buf)
        self.buf += _padded(data)
        return addr

    def _collect_strings(self, obj):
        if obj._addr is not None:
            return
        for v in obj.attrs.values():
            if isinstance(v, str) and v.encode("utf-8") not in self.strings:
                self.strings.append(v.encode("utf-8"))
        for c in getattr(obj, "_children", {}).values():
            if not isinstance(c, int):
                self._collect_strings(c)

    def header(self, msgs: list[tuple[int, bytes]]) -> int:
        body = b""
        for mtype, data in msgs:
            data = _padded(data)
            body += struct.pack("<HHB3x", mtype, len(data), 0) + data
        prefix = struct.pack("<BBHII", 1, 0, len(msgs), 1, len(body)) + b"\0" * 4
        return self.alloc(prefix + body)

    def attr_msgs(self, attrs) -> list:
        out = []
        for name, v in attrs.items():
            nm = name.encode() + b"\0"
            if isinstance(v, str):
                dt, shape = _VLEN_STR, ()
                idx = self.strings.index(v.encode("utf-8")) + 1
                data = struct.pack("<IQI", len(v.encode("utf-8")), self.gheap_at, idx)
            else:
                a = np.asarray(v)
                if a.dtype.kind == "U":
                    raise NotImplementedError("arrays of strings as attributes")
                if a.dtype.kind == "b":
                    a = a.astype(np.int8)
                a = a.astype(a.dtype.newbyteorder("<"))
                dt, shape, data = a.dtype, a.shape, a.tobytes()
            tmsg, smsg = _dtype_message(dt), self.space(shape)
            body = struct.pack("<BBHHH", 1, 0, len(nm), len(tmsg), len(smsg))
            out.append((0x0C, body + _padded(nm) + _padded(tmsg) + _padded(smsg) + data))
        return out

    @staticmethod
    def space(shape) -> bytes:
        return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
            struct.pack("<Q", s) for s in shape)

    def obj(self, o) -> int:
        if isinstance(o, int):  # an object of the file, not read
            return o
        if o._addr is not None:  # one that was read: unchanged
            return o._addr
        if isinstance(o, Group):
            return self.group(o)[0]
        msgs = [(0x01, self.space(o.shape)), (0x03, _dtype_message(o.dtype))]
        if o.chunks is None:
            msgs += [(0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0])),  # fill value: zeros
                     (0x08, struct.pack("<BBQQ", 3, 1, o._data_at, o.dtype.itemsize * math.prod(
                         o.shape)))]  # contiguous layout
        else:
            nd = len(o.shape) + 1
            msgs.append((0x05, bytes([2, 3, 2, 1, 0, 0, 0, 0])))  # zeros, allocated chunk by chunk
            if o._pipeline:
                msgs.append((0x0B, _pipeline_message(o._pipeline)))
            msgs.append((0x08, struct.pack(f"<BBBQ{nd}I", 3, 2, nd, self.chunk_tree(o), *o.chunks,
                                           o.dtype.itemsize)))  # chunked layout
        return self.header(msgs + self.attr_msgs(o.attrs))

    def chunk_tree(self, ds: Dataset) -> int:
        """The v1 B-tree (node type 1) over ``ds``'s stored chunks, as HDF5
        lays it out: each node of ``2 K`` entries at full size (so HDF5 can
        insert into it), a key per chunk (stored size, filter mask, offset
        with a last 0 for the element), a last key past the last chunk, the
        levels above keyed by each child's first key; its root's address,
        UNDEF where no chunk is stored."""
        if not ds._index:
            return UNDEF
        nd = len(ds.shape) + 1
        cap, key = 2 * self.f._istore_k, 8 + 8 * nd
        size = 24 + cap * (key + 8) + key
        kids = [(struct.pack(f"<II{nd}Q", n, mask, *(p * c for p, c in zip(pos, ds.chunks)), 0),
                 addr) for pos, (addr, n, mask) in sorted(ds._index.items())]
        last = max(ds._index)
        end = struct.pack(f"<II{nd}Q", 0, 0, *((p + 1) * c for p, c in zip(last, ds.chunks)),
                          ds.dtype.itemsize)
        level = 0
        while True:
            nodes = [kids[i : i + cap] for i in range(0, len(kids), cap)]
            first = self.base + len(self.buf)
            up = []
            for j, group in enumerate(nodes):
                left = first + (j - 1) * size if j else UNDEF
                right = first + (j + 1) * size if j + 1 < len(nodes) else UNDEF
                node = b"TREE" + bytes([1, level]) + struct.pack("<HQQ", len(group), left, right)
                node += b"".join(k + struct.pack("<Q", a) for k, a in group)
                node += nodes[j + 1][0][0] if j + 1 < len(nodes) else end
                up.append((group[0][0], self.alloc(node + b"\0" * (size - len(node)))))
            if len(up) == 1:
                return up[0][1]
            kids, level = up, level + 1

    def group(self, g: Group) -> tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of group ``g``."""
        names = sorted(g._children)  # symbol nodes keep their entries sorted
        addrs = [self.obj(g._children[n]) for n in names]
        heap_data, offs = b"\0" * 8, []  # offset 0: the empty name, the first key
        for n in names:
            offs.append(len(heap_data))
            heap_data += _padded(n.encode() + b"\0")
        data_at = self.alloc(heap_data)
        heap = self.alloc(b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
            "<QQQ", len(heap_data), 1, data_at))  # 1: no free block
        cap = 2 * self.f._leaf_k
        leaves = []  # (symbol node address, heap offset of its last name)
        for i in range(0, len(names), cap):
            snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names[i : i + cap]))
            snod += b"".join(struct.pack("<QQII16x", off, a, 0, 0)
                             for off, a in zip(offs[i : i + cap], addrs[i : i + cap]))
            leaves.append((self.alloc(snod + b"\0" * (8 + cap * 40 - len(snod))),
                           offs[min(i + cap, len(names)) - 1]))
        btree = self.tree(leaves, 0)
        msgs = [(0x11, struct.pack("<QQ", btree, heap))] + self.attr_msgs(g.attrs)
        return self.header(msgs), btree, heap

    def tree(self, children: list, level: int) -> int:
        """A v1 group B-tree level over ``children`` (address, key = heap
        offset of the last name under it), its nodes back to back with
        their sibling links; the levels above it in turn; the root's
        address."""
        cap = 2 * self.f._node_k
        size = 24 + cap * 16 + 8
        nodes = [children[i : i + cap] for i in range(0, len(children), cap)] or [[]]
        first = self.base + len(self.buf)
        up = []
        for j, kids in enumerate(nodes):
            left = first + (j - 1) * size if j else UNDEF
            right = first + (j + 1) * size if j + 1 < len(nodes) else UNDEF
            node = b"TREE" + bytes([0, level]) + struct.pack("<HQQ", len(kids), left, right)
            node += struct.pack("<Q", nodes[j - 1][-1][1] if j else 0)
            node += b"".join(struct.pack("<QQ", a, key) for a, key in kids)
            up.append((self.alloc(node + b"\0" * (size - len(node))), kids[-1][1] if kids else 0))
        return up[0][0] if len(up) == 1 else self.tree(up, level + 1)
