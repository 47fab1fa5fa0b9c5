"""tensorstore's OCDBT key-value database, read and written in Python.

An OCDBT database is a directory with ``manifest.ocdbt`` and data files
(``d/<name>``). The manifest holds the configuration and an inline version
tree; each version names the root of a B-tree. B-tree nodes and large values
live in data files, addressed by (file, offset, length). Every manifest and
node is framed as::

    magic (uint32 big-endian) | total length (uint64 LE) | version (varint, 0)
    | compression (varint: 0 none, 1 zstd) | body (zstd frame if 1) | CRC-32C (uint32 LE)

Integers in the bodies are unsigned LEB128 varints unless noted, and every
per-entry field is stored as one column over all entries. A node's keys are
prefix-compressed against their predecessor and are relative to the common
prefix of the node's subtree, which the parent's entry records. A data file
path is ``base_path + relative_path`` relative to the database directory; a
node reached through a file whose base path is ``B`` resolves its own paths
under ``B`` (this is how Orbax's top-level database points into
``ocdbt.process_0/``).

:func:`read_kv` returns the latest version's keys and values;
:func:`write_kv` writes a new database of one version: one data file holding
the out-of-line values, the leaf nodes (as many as
``max_decoded_node_bytes`` asks for) and the interior nodes above them, and
a manifest that declares zstd. Its nodes are raw-block zstd frames
(:func:`.zstd.compress_raw`).
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
_NONE = (1 << 64) - 1  # the offset / length of an empty tree's root
# tensorstore's defaults, which Orbax keeps.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT format checks every manifest and node."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _In:
    """A cursor over a decoded body; every read past the end raises ``ValueError``."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long at byte {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"OCDBT {self.what}: {len(self.data) - self.pos} bytes left over")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node, after checking its magic, length and CRC-32C."""
    if len(buf) < 18:
        raise ValueError(f"OCDBT {what}: {len(buf)} bytes is too short")
    found, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if found != magic:
        raise ValueError(f"OCDBT {what}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise ValueError(f"OCDBT {what}: header says {length} bytes, found {len(buf)}")
    if crc32c(buf[:-4]) != struct.unpack("<I", buf[-4:])[0]:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _In(buf[12:-4], what)
    if head.varint() != 0:
        raise ValueError(f"OCDBT {what}: unknown format version")
    compression = head.varint()
    body = buf[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"OCDBT {what}: unknown compression {compression}")


def _frame(body: bytes, magic: int) -> bytes:
    payload = b"\x00\x01" + zstd.compress_raw(body)  # version 0, zstd
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    buf = head + payload
    return buf + struct.pack("<I", crc32c(buf))


# ---------------------------------------------------------------- reading

def _read_config(r: _In) -> int:
    """Reads the manifest's configuration; returns its manifest kind (0: one manifest file).

    uuid (16 bytes), manifest kind, max inline value bytes, max decoded node
    bytes (varints), version tree arity log2 (a byte), compression (varint:
    0 none, 1 zstd, then the zstd level as int32 LE).
    """
    r.take(16)
    kind = r.varint()
    r.varint(), r.varint()
    r.byte()
    compression = r.varint()
    if compression not in (0, 1):
        raise ValueError(f"OCDBT manifest: unknown compression method {compression}")
    if compression == 1:
        r.take(4)
    return kind


def _read_files(r: _In, base: str) -> List[Tuple[str, str]]:
    """A data-file table: ``(base path, full path)`` of each file, under ``base``."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data-file prefix length")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"OCDBT {r.what}: bad base-path length")
        text = path.decode()
        out.append((base + text[:base_len[i]], base + text))
        prev = path
    return out


def _read_keys(r: _In, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad key prefix length")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


class _Files:
    """Reads byte ranges of the database's data files, one open file each."""

    def __init__(self, root: str):
        self.root, self.open = root, {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        f = self.open.get(path)
        if f is None:
            f = self.open[path] = open(os.path.join(self.root, path), "rb")
        data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} holds no {length} bytes at offset {offset}")
        return data

    def close(self) -> None:
        for f in self.open.values():
            f.close()


def _read_node(files: _Files, out: Dict[str, bytes], ref: Tuple[str, str], offset: int,
               length: int, height: int, prefix: bytes) -> None:
    base, path = ref
    what = f"node {path}@{offset}"
    r = _In(_unframe(files.read(path, offset, length), NODE_MAGIC, what), what)
    if r.byte() != height:
        raise ValueError(f"OCDBT {what}: height differs from its parent's entry")
    table = _read_files(r, base)
    n = r.varint()
    keys, common = _read_keys(r, n, interior=height > 0)

    def file(i: int) -> Tuple[str, str]:
        if i >= len(table):
            raise ValueError(f"OCDBT {what}: data file {i} of {len(table)}")
        return table[i]

    if height > 0:
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # the children's key counts and byte counts
        r.end()
        for i in range(n):
            _read_node(files, out, file(ids[i]), offsets[i], lengths[i], height - 1,
                       prefix + keys[i][:common[i]])
        return
    lengths = r.varints(n)
    kinds = r.varints(n)
    indirect = [i for i in range(n) if kinds[i] == 1]
    if any(k not in (0, 1) for k in kinds):
        raise ValueError(f"OCDBT {what}: unknown value kind")
    ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
    for i, fid, off in zip(indirect, ids, offsets):
        out[(prefix + keys[i]).decode()] = files.read(file(fid)[1], off, lengths[i])
    for i in range(n):
        if kinds[i] == 0:
            out[(prefix + keys[i]).decode()] = r.take(lengths[i])
    r.end()


def read_kv(directory: str) -> Dict[str, bytes]:
    """Every key and value of the latest version of the database in ``directory``."""
    with open(os.path.join(directory, MANIFEST_FILE), "rb") as f:
        body = _unframe(f.read(), MANIFEST_MAGIC, "manifest")
    r = _In(body, "manifest")
    kind = _read_config(r)
    if kind != 0:
        raise ValueError("OCDBT manifest: only single-file manifests are supported "
                         f"(manifest kind {kind})")
    table = _read_files(r, "")
    n = r.varint()
    gens = r.varints(n)
    heights = [r.byte() for _ in range(n)]
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)
    r.take(8 * n)  # commit times
    if not n:
        raise ValueError("OCDBT manifest: no inline version (a version-tree node is not supported)")
    latest = max(range(n), key=gens.__getitem__)
    out: Dict[str, bytes] = {}
    if offsets[latest] == _NONE:
        return out
    if ids[latest] >= len(table):
        raise ValueError(f"OCDBT manifest: data file {ids[latest]} of {len(table)}")
    files = _Files(directory)
    try:
        _read_node(files, out, table[ids[latest]], offsets[latest], lengths[latest],
                   heights[latest], b"")
    finally:
        files.close()
    return out


# ---------------------------------------------------------------- writing

def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _files_table(path: str) -> bytes:
    data = path.encode()
    return _varints([1, len(data), 0]) + data


def _keys(keys: List[bytes]) -> Tuple[bytes, bytes, bytes]:
    """Prefix lengths against the predecessor, suffix lengths and suffix bytes."""
    prefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffixes = [k[p:] for k, p in zip(keys, [0] + prefix)]
    return _varints(prefix), _varints(len(s) for s in suffixes), b"".join(suffixes)


@dataclass
class _Ref:
    """A written node, as its parent's entry names it."""

    first: bytes  # its first key, in full
    last: bytes  # its last key, in full
    offset: int
    length: int
    keys: int
    tree_bytes: int
    indirect_bytes: int


class _DataFile:
    def __init__(self, f, path: str):
        self.f, self.path, self.offset = f, path, 0

    def write(self, data: bytes) -> int:
        at = self.offset
        self.f.write(data)
        self.offset += len(data)
        return at


def _leaf(out: _DataFile, entries, prefix: int) -> _Ref:
    """``entries``: (full key, value, indirect offset or None); keys relative to ``prefix`` bytes."""
    keys = [k[prefix:] for k, _, _ in entries]
    p, s, data = _keys(keys)
    indirect = [(off, len(v)) for _, v, off in entries if off is not None]
    body = b"".join([
        b"\x00", _files_table(out.path) if indirect else _varint(0), _varint(len(entries)),
        p, s, data,
        _varints(len(v) for _, v, _ in entries),
        _varints(int(off is not None) for _, _, off in entries),
        _varints(0 for _ in indirect), _varints(off for off, _ in indirect),
        *(v for _, v, off in entries if off is None),
    ])
    node = _frame(body, NODE_MAGIC)
    return _Ref(entries[0][0], entries[-1][0], out.write(node), len(node), len(entries),
                len(node), sum(n for _, n in indirect))


def _interior(out: _DataFile, children: List[_Ref], height: int, prefix: int) -> _Ref:
    keys = [c.first[prefix:] for c in children]
    p, s, data = _keys(keys)
    common = [_common(c.first, c.last) - prefix for c in children]
    body = b"".join([
        bytes([height]), _files_table(out.path), _varint(len(children)), p, s, _varints(common),
        data,
        _varints(0 for _ in children), _varints(c.offset for c in children),
        _varints(c.length for c in children),
        _varints(c.keys for c in children), _varints(c.tree_bytes for c in children),
        _varints(c.indirect_bytes for c in children),
    ])
    node = _frame(body, NODE_MAGIC)
    return _Ref(children[0].first, children[-1].last, out.write(node), len(node),
                sum(c.keys for c in children), len(node) + sum(c.tree_bytes for c in children),
                sum(c.indirect_bytes for c in children))


def _groups(sizes: List[int], limit: int) -> List[Tuple[int, int]]:
    """Consecutive [start, stop) runs whose sizes add up to at most ``limit`` (at least one each)."""
    runs, start, total = [], 0, 0
    for i, size in enumerate(sizes):
        if i > start and total + size > limit:
            runs.append((start, i))
            start, total = i, 0
        total += size
    runs.append((start, len(sizes)))
    return runs


def write_kv(
    directory: str,
    kv: Mapping[str, bytes],
    *,
    max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES,
) -> None:
    """Write ``kv`` as a new OCDBT database in ``directory`` (which must hold none).

    Values longer than ``MAX_INLINE_VALUE_BYTES`` go to the data file; the
    nodes are split so that no decoded node body exceeds
    ``max_decoded_node_bytes`` where it can (a leaf holds at least one entry,
    an interior node two children).
    """
    if os.path.exists(os.path.join(directory, MANIFEST_FILE)):
        raise FileExistsError(f"an OCDBT database exists in {directory}")
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    items = sorted((k.encode(), v) for k, v in kv.items())
    path = f"d/{uuid.uuid4().hex}"
    root: Optional[_Ref] = None
    height = 0
    if items:
        with open(os.path.join(directory, path), "wb") as f:
            out = _DataFile(f, path)
            entries = []
            for key, value in items:
                value = bytes(value)
                big = len(value) > MAX_INLINE_VALUE_BYTES
                entries.append((key, value, out.write(value) if big else None))
            # A leaf entry costs its key, its inline value and at most 4 varints
            # (10 bytes each); an interior entry its key and 7 varints.
            sizes = [len(k) + 40 + (0 if off is not None else len(v)) for k, v, off in entries]
            runs = _groups(sizes, max_decoded_node_bytes - 64)
            if len(runs) == 1:
                root = _leaf(out, entries, 0)
            else:
                level = [_leaf(out, entries[lo:hi], _common(entries[lo][0], entries[hi - 1][0]))
                         for lo, hi in runs]
                while True:
                    height += 1
                    sizes = [len(c.first) + 70 for c in level]
                    runs = _groups(sizes, max_decoded_node_bytes - 64)
                    if len(runs) == len(level):  # at least two children a node, so the tree ends
                        runs = [(lo, min(lo + 2, len(level))) for lo in range(0, len(level), 2)]
                    if len(runs) == 1:
                        root = _interior(out, level, height, 0)
                        break
                    level = [_interior(out, level[lo:hi], height,
                                       _common(level[lo].first, level[hi - 1].last))
                             for lo, hi in runs]
    config = b"".join([
        uuid.uuid4().bytes, _varints([0, MAX_INLINE_VALUE_BYTES, max_decoded_node_bytes]),
        bytes([VERSION_TREE_ARITY_LOG2]), _varint(1), struct.pack("<i", 0),
    ])
    if root is None:
        table = _varints([1, 0, 0])
        location = [0, _NONE, _NONE]
        stats = [0, 0, 0]
    else:
        table = _files_table(path)
        location = [0, root.offset, root.length]
        stats = [root.keys, root.tree_bytes, root.indirect_bytes]
    versions = b"".join([
        _varint(1), _varint(1), bytes([height]), _varints(location), _varints(stats),
        struct.pack("<Q", time.time_ns()), _varint(0),
    ])
    manifest = _frame(config + table + versions, MANIFEST_MAGIC)
    target = os.path.join(directory, MANIFEST_FILE)
    tmp = f"{target}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, target)
