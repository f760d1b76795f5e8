"""TensorStore's OCDBT key-value store, read-only, without TensorStore: the
store under every Orbax checkpoint that ``twinvoice_tpu.train.checkpoint``
writes (``save``, ``save_params``: ``use_ocdbt`` is orbax's default).

:class:`OcdbtStore` lists and reads the keys of a store's latest version as
TensorStore's ``ocdbt`` driver does over a ``file://`` base:

- ``manifest.ocdbt`` (magic ``0x0cdb3a2a``): the config (uuid, manifest
  kind, inline value limit, node size limit, version tree arity,
  compression), then the version tree's inline leaf entries and references
  to version tree nodes (magic ``0x0cdb1234``) of older versions; the
  newest generation, always inline, gives the B+tree root.
- B+tree nodes (``0x0cdb20de``) at every height: each node carries a table
  of the data files it names, its
  keys prefix-coded (interior entries also strip their subtree's common
  prefix from the keys below them), values inline or indirect (data file,
  offset, length), children by (data file, offset, length).
- A data file's path is its base path and its relative path; a node read
  from a file under base path ``B`` names files under ``B`` followed by
  their own base path (Orbax's merged root points into
  ``ocdbt.process_<n>/d/``).
- Every file (or node within a data file) has a header (magic, length,
  version 0, compression 0 or 1 = zstd, decoded by ``ops/host_zstd``) and a
  CRC-32C footer, which is checked.

An unknown magic, version or compression, a numbered manifest, a bad
checksum and a truncated file or node raise ``ValueError`` naming what was
found. Nodes are small (TensorStore caps them at the config's decoded size),
so this is Python with ``struct`` and varints.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from twinvoice_tpu_torch.ops.host_zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # the location of an empty tree


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT footers carry it."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over bytes: little-endian fixed widths and LEB128 varints."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT: {self.what} is truncated")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def u64(self) -> int:
        self._need(8)
        self.pos += 8
        return struct.unpack_from("<Q", self.data, self.pos - 8)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT: {self.what} has a varint past 64 bits")

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def take(self, n) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """One encoded manifest or node → its body: header (magic, length,
    version, compression), body, CRC-32C footer."""
    if len(data) < 4:
        raise ValueError(f"OCDBT: {what} is truncated")
    got = struct.unpack_from(">I", data, 0)[0]
    if got != magic:
        raise ValueError(f"OCDBT: {what} has magic {got:#010x}, expected {magic:#010x}")
    r = _Reader(data, what)
    r.pos = 4
    length = r.u64()
    if length != len(data):
        raise ValueError(f"OCDBT: {what} is {len(data)} bytes, its header says {length}"
                         + (" (truncated)" if length > len(data) else ""))
    version = r.varint()
    if version != 0:
        raise ValueError(f"OCDBT: {what} has format version {version}; only 0 is known")
    compression = r.varint()
    if len(data) < r.pos + 4:
        raise ValueError(f"OCDBT: {what} is truncated")
    crc = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"OCDBT: {what} fails its CRC-32C check")
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise ValueError(f"OCDBT: {what} has compression {compression}; only 0 (none) "
                     f"and 1 (zstd) are known")


@dataclass(frozen=True)
class DataFile:
    base: str       # base path (with a trailing "/" where not empty)
    relative: str

    @property
    def path(self) -> str:
        return self.base + self.relative


@dataclass(frozen=True)
class Location:
    file: DataFile
    offset: int
    length: int


def _data_file_table(r: _Reader, base: str):
    """The table of data files a node names, each under ``base`` (the base
    path of the file the node was read from)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT: {r.what} has a bad data file table")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"OCDBT: {r.what} has a bad data file table")
        files.append(DataFile(base + path[:base_len[i]].decode(), path[base_len[i]:].decode()))
        prev = path
    return files


def _locations(r: _Reader, files, n):
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if i >= len(files):
            raise ValueError(f"OCDBT: {r.what} names data file {i} of {len(files)}")
        out.append(Location(files[i], o, ln))
    return out


@dataclass(frozen=True)
class Version:
    generation: int
    height: int
    root: Location


class OcdbtStore:
    """The latest version of the OCDBT store in the directory ``root``."""

    def __init__(self, root):
        self.root = os.fspath(root)
        self._files = {}
        data = self._read_file("manifest.ocdbt")
        r = _Reader(decode_file(data, MANIFEST_MAGIC, "manifest.ocdbt"), "manifest.ocdbt")
        r.take(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"OCDBT: manifest kind {kind} (numbered manifests) is not read here")
        r.varints(2)  # the inline value and decoded node limits
        r.u8()  # the version tree's arity
        method = r.varint()
        if method == 1:
            r.take(4)  # the zstd level
        elif method != 0:
            raise ValueError(f"OCDBT: manifest names compression method {method}")
        files = _data_file_table(r, "")
        leaves = self._version_leaves(r, files)
        refs = self._version_refs(r, files)
        self.version = self._latest(leaves, refs)
        self._index = None

    # -- files -----------------------------------------------------------

    def _read_file(self, rel: str) -> bytes:
        path = os.path.join(self.root, rel)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ValueError(f"OCDBT: {path} is missing") from None

    def _read(self, loc: Location) -> bytes:
        data = self._files.get(loc.file.path)
        if data is None:
            data = self._files[loc.file.path] = self._read_file(loc.file.path)
        if loc.offset + loc.length > len(data):
            raise ValueError(f"OCDBT: {loc.file.path} is {len(data)} bytes; "
                             f"[{loc.offset}, {loc.offset + loc.length}) is past its end")
        return data[loc.offset:loc.offset + loc.length]

    # -- the version tree ---------------------------------------------------

    @staticmethod
    def _version_leaves(r, files):
        n = r.varint()
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        locs = _locations(r, files, n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        [r.u64() for _ in range(n)]  # commit times
        return [Version(g, h, loc) for g, h, loc in zip(gens, heights, locs)]

    @staticmethod
    def _version_refs(r, files):
        n = r.varint()
        gens = r.varints(n)
        locs = _locations(r, files, n)
        r.varints(n)  # generations below each
        [r.u64() for _ in range(n)]  # commit times
        heights = [r.u8() for _ in range(n)]
        return [(g, h, loc) for g, h, loc in zip(gens, heights, locs)]

    @staticmethod
    def _latest(leaves, refs) -> Version:
        """The newest generation: TensorStore keeps it among the manifest's
        inline leaf entries (older ones move into version tree nodes)."""
        best = max(leaves, key=lambda v: v.generation, default=None)
        newest_ref = max((g for g, _, _ in refs), default=-1)
        if best is None or newest_ref > best.generation:
            raise ValueError("OCDBT: the manifest's newest version is not inline "
                             f"(inline {best and best.generation}, in nodes {newest_ref})")
        return best

    # -- the B+tree -----------------------------------------------------------

    def _node(self, loc: Location, height: int, prefix: bytes, out: dict):
        what = f"B+tree node in {loc.file.path} at {loc.offset}"
        r = _Reader(decode_file(self._read(loc), BTREE_MAGIC, what), what)
        h = r.u8()
        if h != height:
            raise ValueError(f"OCDBT: {what} has height {h}, its parent says {height}")
        files = _data_file_table(r, loc.file.base)
        n = r.varint()
        prefix_len = [0] + r.varints(n - 1) if n else []
        suffix_len = r.varints(n)
        common = r.varints(n) if h > 0 else None
        keys, prev = [], b""
        for i in range(n):
            if prefix_len[i] > len(prev):
                raise ValueError(f"OCDBT: {what} has a bad key prefix")
            prev = prev[:prefix_len[i]] + r.take(suffix_len[i])
            keys.append(prev)
        if h > 0:
            children = _locations(r, files, n)
            r.varints(3 * n)  # statistics
            for key, c, child in zip(keys, common, children):
                self._node(child, h - 1, prefix + key[:c], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"OCDBT: {what} has a value kind other than 0 or 1")
        n_ind = sum(kinds)
        ids, offsets = r.varints(n_ind), r.varints(n_ind)
        ind = 0
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind:
                if ids[ind] >= len(files):
                    raise ValueError(f"OCDBT: {what} names data file {ids[ind]} of {len(files)}")
                out[prefix + key] = Location(files[ids[ind]], offsets[ind], ln)
                ind += 1
            else:
                out[prefix + key] = r.take(ln)

    def _entries(self) -> dict:
        if self._index is None:
            index = {}
            v = self.version
            if v.root.offset != MISSING:
                self._node(v.root, v.height, b"", index)
            self._index = dict(sorted(index.items()))
        return self._index

    def keys(self) -> list:
        """Every key of the latest version, in order (bytes)."""
        return list(self._entries())

    def read(self, key) -> bytes:
        """The value of ``key`` (bytes or str). Raises ``KeyError`` if absent."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        v = self._entries()[key]
        return v if isinstance(v, bytes) else self._read(v)

    def __contains__(self, key) -> bool:
        key = key.encode() if isinstance(key, str) else bytes(key)
        return key in self._entries()
