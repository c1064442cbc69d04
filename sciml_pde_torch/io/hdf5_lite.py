"""A subset of HDF5 in Python and numpy, for hosts without h5py.

``io/h5.py::h5py_module`` hands this module out where h5py is not
installed.  It offers the calls of h5py that the port makes (``File``,
``Group``, ``Dataset``, ``attrs``, ``create_dataset``, slicing) on files of
the HDF5 1.8 "earliest" format that h5py writes by default: a version 0/1
superblock, version 1 object headers, groups as symbol tables (v1 B-tree,
local heap, symbol nodes) and attributes (numbers, arrays, variable-length
UTF-8 strings in a global heap).

Datasets are contiguous and uncompressed.  ``create_dataset`` takes h5py's
``compression``, ``chunks`` and ``shuffle`` and ignores them, so a file
written here is the size of its data, where h5py's LZF file of the same
data is smaller.  Reading takes contiguous datasets only: a chunked dataset
(every compressed one) raises NotImplementedError.

Writing only appends.  A dataset's bytes go to the end of the file when it
is created, and ``__setitem__`` writes them through a memory map.  Closing
appends the new objects' headers and a new root group, syncs, and then
rewrites the superblock to point at that root: the one write in place.
Until then the file holds its previous tree, so a session that raises, or
a process killed mid-write, loses nothing the file held, and an append
costs its own bytes, not the file's.  A session that raises commits
nothing.  Objects the file already held are read-only; new members are
added to the root group and to groups created in the session.

A file open for writing holds an exclusive ``flock``, one open for reading
a shared one, as HDF5's own file locking does: a second writer gets
``BlockingIOError`` (an ``OSError``), which ``io/h5.py::write_seed_groups``
retries.
"""

from __future__ import annotations

import fcntl
import math
import mmap
import os
import struct

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIG = b"\x89HDF\r\n\x1a\n"
_LEAF_K, _NODE_K = 4, 16  # HDF5's default symbol-node and group B-tree K


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


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

    def node(self, addr):
        """The object at ``addr``: ('group', links, attrs) or ('dataset',
        (shape, dtype, data address), attrs)."""
        attrs, info, links = {}, {}, None
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
            elif mtype == 0x08:
                ver, cls = self.b[o], self.b[o + 1]
                if ver != 3 or cls != 1:
                    raise NotImplementedError(
                        f"a dataset of layout class {cls} (version {ver}): this subset reads "
                        "contiguous ones only (a compressed file needs h5py)")
                info["addr"], = self.u("Q", o + 2)
            elif mtype in (0x02, 0x06, 0x0A):
                raise NotImplementedError("new-style (link message) groups")
        if links is not None:
            return "group", links, attrs
        return "dataset", (info["shape"], info["dtype"], info["addr"]), attrs


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
    compression, chunks, shuffle = None, None, False  # contiguous, unfiltered

    def __init__(self, file, shape, dtype, data_at: int, writable: bool):
        self.file = file
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.attrs = AttributeManager()
        self._addr = None  # object header address, for an object the file held
        self._data_at = data_at
        n = math.prod(self.shape)
        if n == 0 or data_at == UNDEF:
            self._mm = np.zeros(self.shape, self.dtype)
        else:
            self._mm = np.memmap(file.filename, self.dtype, "r+" if writable else "r",
                                 offset=data_at, shape=(n,)).reshape(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        return np.array(self._mm, dtype=dtype)

    def __getitem__(self, idx):
        return np.array(self._mm[idx])

    def __setitem__(self, idx, value):
        self.file._check_writable()
        self._mm[idx] = value


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
                       chunks=None, shuffle=False):
        """h5py's call; ``compression``, ``chunks`` and ``shuffle`` are
        ignored (the data is stored contiguous and unfiltered)."""
        self.file._check_writable()
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            shape = data.shape if shape is None else tuple(shape)
        dt = np.dtype(dtype if dtype is not None else (data.dtype if data is not None else "f4"))
        g, last = self._walk(name, create=True)
        ds = self.file._new_dataset(shape, dt.newbyteorder("<"))
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
                self._commit()  # an empty file, whatever becomes of the session
            else:
                r = self._reader = _Reader(self._fd, path)
                self._sb = bytearray(r.b[: r.sb_size])
                self._leaf_k, self._node_k, self._eoa = r.leaf_k, r.node_k, _pad8(r.eoa)
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
            obj = Dataset(self, *info, writable=False)
        obj._addr = addr
        obj.attrs.update(attrs)
        obj.attrs.read_only = True
        return obj

    def _new_dataset(self, shape, dt) -> Dataset:
        nbytes = math.prod(shape) * dt.itemsize
        data_at = UNDEF
        if nbytes:
            data_at, self._eoa = self._eoa, _pad8(self._eoa + nbytes)
            if os.fstat(self._fd).st_size < self._eoa:
                os.ftruncate(self._fd, self._eoa)
        ds = Dataset(self, shape, dt, data_at, writable=True)
        self._new.append(ds)
        return ds

    def _check_writable(self):
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")

    def _commit(self):
        """Append the new objects and a new root group, then point the
        superblock at them."""
        for ds in self._new:
            if isinstance(ds._mm, np.memmap):
                ds._mm.flush()
        w = _Writer(self, self._eoa)
        root_header, btree, heap = w.group(self)
        os.pwrite(self._fd, w.buf, self._eoa)
        self._eoa += len(w.buf)
        os.fsync(self._fd)
        o = len(self._sb) - 72  # base address, free space, end of file, driver info, root entry
        struct.pack_into("<Q", self._sb, o + 16, self._eoa)
        struct.pack_into("<QQIIQQ", self._sb, o + 32, 0, root_header, 1, 0, btree, heap)
        os.pwrite(self._fd, self._sb, 0)
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
        msgs = [(0x01, self.space(o.shape)), (0x03, _dtype_message(o.dtype)),
                (0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0])),  # fill value: zeros
                (0x08, struct.pack("<BBQQ", 3, 1, o._data_at, o.dtype.itemsize * math.prod(
                    o.shape)))]  # contiguous layout
        return self.header(msgs + self.attr_msgs(o.attrs))

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
