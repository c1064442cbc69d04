"""OCDBT, tensorstore's "optionally-cooperative distributed B+tree" key-value
store, as the JAX package's orbax checkpoints hold it: read and write it
without tensorstore.

A database is a directory: ``manifest.ocdbt`` and data files under
``d/``; orbax's checkpoint has one database at the top whose tree points
into the data files of each writing process's own database
(``ocdbt.process_N/d/...``).  Every manifest and B+tree node is

    magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node)
    length of the whole (u64 LE), version (varint, 0),
    compression (varint: 0 none, 1 zstd), body, CRC-32C of all before (u32 LE)

and integers in a body are LEB128 varints unless named.  The manifest body:

    config   uuid[16] manifest_kind max_inline_value_bytes
             max_decoded_node_bytes version_tree_arity_log2 (byte)
             compression (0, or 1 and the zstd level as i32 LE)
    data file table   n, prefix_len[n-1], suffix_len[n], base_path_len[n],
             the suffixes: path i is path i-1's first prefix_len bytes and
             its suffix, relative to the database's directory
    versions n, generation[n], root_height[n] (bytes), data_file[n],
             offset[n], length[n], num_keys[n], num_tree_bytes[n],
             num_indirect_value_bytes[n], commit_time[n] (u64 LE)
    version tree nodes  m, generation[m], data_file[m], offset[m],
             length[m], num_generations[m], commit_time[m] (u64), height[m]

The newest version is always among the manifest's own.  A node body:

    height (byte), data file table, n entries,
    key_prefix_len[n-1], key_suffix_len[n], (interior: subtree_prefix_len[n]),
    the key suffixes; keys are prefix-compressed against the previous key
    and relative to the prefix the node inherits
    leaf:     value_len[n], value_kind[n] (0 inline, 1 in a data file),
              data_file[k], offset[k] of the k others, the inline values
    interior: data_file[n], offset[n], length[n], num_keys[n],
              num_tree_bytes[n], num_indirect_value_bytes[n]; a child
              inherits its parent's prefix and the entry key's first
              subtree_prefix_len bytes

A root whose data file is the empty path at offset and length 2^64 - 1 is
an empty tree.  ``OcdbtReader`` reads the newest version, checking every
file's magic, length, version and CRC, and fetches only the byte ranges the
keys name; ``write_database`` writes one database with the values above
orbax's 1024 bytes and every node in one data file.  The public
description is tensorstore's "OCDBT storage format" page.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from pathlib import Path

from sciml_pde_torch.io import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MISSING = (1 << 64) - 1
ORBAX_MAX_INLINE, ORBAX_MAX_NODE_BYTES = 1024, 100_000_000


class OcdbtError(ValueError):
    pass


class _Body:
    def __init__(self, data: bytes, what: str):
        self.b, self.i, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise OcdbtError(f"{self.what}: truncated at byte {self.i}")

    def byte(self) -> int:
        self.need(1)
        self.i += 1
        return self.b[self.i - 1]

    def raw(self, n: int) -> bytes:
        self.need(n)
        self.i += n
        return self.b[self.i - n:self.i]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.i != len(self.b):
            raise OcdbtError(f"{self.what}: {len(self.b) - self.i} bytes left over")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _open_envelope(data: bytes, magic: int, what: str, max_body: int | None = None) -> bytes:
    """The body of a manifest or node file, every header field checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise OcdbtError(f"{what}: length field {length}, the file has {len(data)}")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    b = _Body(data[12:-4], what)
    version = b.varint()
    if version != 0:
        raise OcdbtError(f"{what}: unsupported format version {version}")
    comp = b.varint()
    body = b.b[b.i:]
    if comp == 0:
        return body
    if comp == 1:
        try:
            return zstd.decompress(body, max_body)
        except ValueError as e:
            raise OcdbtError(f"{what}: {e}") from None
    raise OcdbtError(f"{what}: unsupported compression {comp}")


def _seal(magic: int, body: bytes) -> bytes:
    payload = _varint(0) + _varint(1) + zstd.compress(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", zstd.crc32c(data))


def _read_table(b: _Body) -> list[str]:
    n = b.varint()
    if n == 0:
        return []
    prefix = [0] + b.varints(n - 1)
    suffix = b.varints(n)
    b.varints(n)  # base path lengths: the paths are whole either way
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtError(f"{b.what}: bad data file table")
        prev = prev[:p] + b.raw(s)
        paths.append(prev.decode())
    return paths


def _write_table(paths: list[str]) -> bytes:
    out = [_varint(len(paths))]
    enc = [p.encode() for p in paths]
    pre = [0] + [_common(a, b) for a, b in zip(enc, enc[1:])]
    out += [_varint(p) for p in pre[1:]]
    out += [_varint(len(e) - p) for e, p in zip(enc, pre)]
    out += [_varint(0)] * len(enc)
    out += [e[p:] for e, p in zip(enc, pre)]
    return b"".join(out)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _read_keys(b: _Body, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    sub = b.varints(n) if interior else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtError(f"{b.what}: bad key prefix")
        prev = prev[:p] + b.raw(s)
        keys.append(prev)
    return keys, sub


@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: int


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    path: str
    offset: int
    length: int
    num_keys: int
    commit_time: int


class OcdbtReader:
    """The newest version of the database at ``root``: ``keys()`` and
    ``get(key)`` (None for a missing key)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        m = _Body(_open_envelope((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC,
                                 f"{self.root}/manifest.ocdbt"), "manifest")
        uid, kind = m.raw(16), m.varint()
        inline, node_bytes, arity = m.varint(), m.varint(), m.byte()
        comp = m.varint()
        level = m.i32() if comp == 1 else 0
        if comp not in (0, 1):
            raise OcdbtError(f"manifest: unsupported compression {comp}")
        self.config = Config(uid, kind, inline, node_bytes, arity, comp, level)
        if kind != 0:
            raise OcdbtError(f"manifest: unsupported manifest kind {kind} (numbered manifests)")
        table = _read_table(m)
        n = m.varint()
        gen, height = m.varints(n), [m.byte() for _ in range(n)]
        fid, off, length, nkeys = m.varints(n), m.varints(n), m.varints(n), m.varints(n)
        m.varints(n), m.varints(n)  # tree bytes, indirect value bytes
        when = [m.u64() for _ in range(n)]
        k = m.varint()
        for _ in range(5):
            m.varints(k)  # generation, data file, offset, length, generations
        [m.u64() for _ in range(k)], [m.byte() for _ in range(k)]
        m.done()
        if n == 0:
            raise OcdbtError("manifest: no version")
        j = max(range(n), key=lambda i: gen[i])
        if fid[j] >= len(table):
            raise OcdbtError("manifest: data file index out of range")
        self.version = Version(gen[j], height[j], table[fid[j]], off[j], length[j], nkeys[j],
                               when[j])
        self._entries: dict[bytes, tuple] = {}
        if not (off[j] == MISSING and length[j] == MISSING):
            self._walk(table[fid[j]], off[j], length[j], height[j], b"")
        if len(self._entries) != nkeys[j]:
            raise OcdbtError(f"tree holds {len(self._entries)} keys, the manifest "
                             f"counts {nkeys[j]}")

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(self.root / path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} asked, {len(data)} there")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"node {path}@{offset}"
        b = _Body(_open_envelope(self._read_range(path, offset, length), NODE_MAGIC, what,
                                 self.config.max_decoded_node_bytes), what)
        if b.byte() != height:
            raise OcdbtError(f"{what}: height is not the reference's {height}")
        table = _read_table(b)
        n = b.varint()
        keys, sub = _read_keys(b, n, height > 0)
        if height > 0:
            fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
            b.varints(n), b.varints(n), b.varints(n)  # statistics
            b.done()
            for i in range(n):
                if fid[i] >= len(table):
                    raise OcdbtError(f"{what}: data file index out of range")
                self._walk(table[fid[i]], off[i], ln[i], height - 1, prefix + keys[i][:sub[i]])
            return
        vlen, kind = b.varints(n), b.varints(n)
        ind = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise OcdbtError(f"{what}: unknown value kind")
        fid, off = b.varints(len(ind)), b.varints(len(ind))
        for i, f, o in zip(ind, fid, off):
            if f >= len(table):
                raise OcdbtError(f"{what}: data file index out of range")
            self._entries[prefix + keys[i]] = ("ref", table[f], o, vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self._entries[prefix + keys[i]] = ("inline", b.raw(vlen[i]))
        b.done()

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._entries)

    def get(self, key: str) -> bytes | None:
        e = self._entries.get(key.encode())
        if e is None:
            return None
        return e[1] if e[0] == "inline" else self._read_range(*e[1:])


def _indirect_bytes(items) -> int:
    return sum(v[1] for _, v in items if not isinstance(v, bytes))


def _leaf_body(items: list[tuple[bytes, bytes | tuple]], prefix: bytes, file_id: int | None,
               table: list[str]) -> bytes:
    keys = [k[len(prefix):] for k, _ in items]
    pre = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
    out = [bytes([0]), _write_table(table), _varint(len(items))]
    out += [_varint(p) for p in pre[1:]] + [_varint(len(k) - p) for k, p in zip(keys, pre)]
    out += [k[p:] for k, p in zip(keys, pre)]
    out += [_varint(len(v) if isinstance(v, bytes) else v[1]) for _, v in items]
    out += [_varint(0 if isinstance(v, bytes) else 1) for _, v in items]
    refs = [v for _, v in items if not isinstance(v, bytes)]
    out += [_varint(file_id or 0) for _ in refs] + [_varint(v[0]) for v in refs]
    out += [v for _, v in items if isinstance(v, bytes)]
    return b"".join(out)


@dataclass
class _Ref:
    first: bytes
    last: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect: int


def _interior_body(children: list[_Ref], prefix: bytes, height: int, table: list[str]) -> bytes:
    keys = [c.first[len(prefix):] for c in children]
    sub = [_common(c.first, c.last) - len(prefix) for c in children]
    pre = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
    out = [bytes([height]), _write_table(table), _varint(len(children))]
    out += [_varint(p) for p in pre[1:]] + [_varint(len(k) - p) for k, p in zip(keys, pre)]
    out += [_varint(s) for s in sub] + [k[p:] for k, p in zip(keys, pre)]
    out += [_varint(0)] * len(children)
    for field in ("offset", "length", "num_keys", "tree_bytes", "indirect"):
        out += [_varint(getattr(c, field)) for c in children]
    return b"".join(out)


def write_database(root: str | Path, items: dict[str, bytes], *,
                   max_decoded_node_bytes: int = ORBAX_MAX_NODE_BYTES) -> None:
    """Write ``items`` (key -> value) as a new OCDBT database of one version
    at ``root`` (a directory that does not hold one): values above orbax's
    1024 bytes and every node in one data file ``d/<hex>``, leaves and
    interior nodes under ``max_decoded_node_bytes`` each (orbax's bound
    keeps a checkpoint in one leaf), the manifest last.  The config is
    orbax's (zstd at level 0), the nodes' bodies zstd raw blocks."""
    if not items:
        raise ValueError("an OCDBT database of no keys is not written")
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    name = f"d/{uuid.uuid4().hex}"
    entries = sorted((k.encode(), v) for k, v in items.items())
    # the values, then the nodes, written to the data file as they are laid out
    with open(root / name, "wb") as f:
        pos = 0
        laid: list[tuple[bytes, bytes | tuple]] = []
        for k, v in entries:
            if len(v) > ORBAX_MAX_INLINE:
                laid.append((k, (pos, len(v))))
                f.write(v)
                pos += len(v)
            else:
                laid.append((k, bytes(v)))

        def put(body: bytes) -> tuple[int, int]:
            nonlocal pos
            node = _seal(NODE_MAGIC, body)
            f.write(node)
            pos += len(node)
            return pos - len(node), len(node)

        def fits(body_len: int) -> bool:
            return body_len <= max_decoded_node_bytes

        # leaves: greedy runs of entries under the node bound (bodies with the full
        # keys bound those with the prefix the tree gives them)
        base = 1 + len(_write_table([name])) + 5
        groups, cur, size = [], [], base
        for k, v in laid:
            add = 2 * len(_varint(len(k))) + len(k) + 1 + (
                len(_varint(len(v))) + len(v) if isinstance(v, bytes) else 3 * 10)
            if cur and not fits(size + add):
                groups.append(cur)
                cur, size = [], base
            cur.append((k, v))
            size += add
        groups.append(cur)
        levels = [[(g[0][0], g[-1][0]) for g in groups]]
        while len(levels[-1]) > 1:
            nxt, cur, size = [], [], base
            for first, last in levels[-1]:
                add = 3 * len(_varint(len(first))) + len(first) + 6 * 10
                if cur and not fits(size + add):
                    nxt.append((cur[0][0], cur[-1][1]))
                    cur, size = [], base
                cur.append((first, last))
                size += add
            nxt.append((cur[0][0], cur[-1][1]))
            if len(nxt) == len(levels[-1]):
                raise ValueError(f"max_decoded_node_bytes {max_decoded_node_bytes} holds no "
                                 f"two children")
            levels.append(nxt)
        top = len(levels) - 1

        def prefix_of(level: int, first: bytes, last: bytes) -> bytes:
            return b"" if level == top else first[:_common(first, last)]

        refs = []
        for g in groups:
            p = prefix_of(0, g[0][0], g[-1][0])
            used = any(not isinstance(v, bytes) for _, v in g)
            off, ln = put(_leaf_body(g, p, 0, [name] if used else []))
            refs.append(_Ref(g[0][0], g[-1][0], off, ln, len(g), ln, _indirect_bytes(g)))
        for level in range(1, top + 1):
            nxt, i = [], 0
            for first, last in levels[level]:
                kids = []
                while i < len(refs) and refs[i].first <= last:
                    kids.append(refs[i])
                    i += 1
                p = prefix_of(level, first, last)
                off, ln = put(_interior_body(kids, p, level, [name]))
                nxt.append(_Ref(first, last, off, ln, sum(c.num_keys for c in kids),
                                ln + sum(c.tree_bytes for c in kids),
                                sum(c.indirect for c in kids)))
            refs = nxt
        (r,) = refs
    config = (uuid.uuid4().bytes + _varint(0) + _varint(ORBAX_MAX_INLINE)
              + _varint(max_decoded_node_bytes) + bytes([4]) + _varint(1) + struct.pack("<i", 0))
    version = b"".join([_varint(1), _varint(1), bytes([top]), _varint(0), _varint(r.offset),
                        _varint(r.length), _varint(r.num_keys), _varint(r.tree_bytes),
                        _varint(r.indirect), struct.pack("<Q", time.time_ns()), _varint(0)])
    manifest = _seal(MANIFEST_MAGIC, config + _write_table([name]) + version)
    tmp = root / f"manifest.ocdbt.{os.getpid()}.tmp"
    tmp.write_bytes(manifest)
    os.replace(tmp, root / "manifest.ocdbt")
