"""Pure-Python LevelDB read compatibility (the reference's second DB backend;
the port's copy of flownet2_tpu/data/leveldb.py).

The reference's data abstraction supports LMDB *and* LevelDB
(src/caffe/util/db.cpp dispatches on DataParameter.backend; db_leveldb.cpp
wraps the C++ library). FlowNet tooling packs LMDB (data/make-lmdbs.sh), but
Caffe users hold LevelDB-packed datasets too — this module makes those
drop-in readable WITHOUT the native leveldb/snappy dependencies.

Everything here is a clean-room implementation of the public on-disk
formats (stable since LevelDB 1.x):

- ``CURRENT`` → names the live ``MANIFEST-N`` file.
- ``MANIFEST``: a log-format file of ``VersionEdit`` records
  (tag-varint encoding: comparator / log number / next file / last
  sequence / compact pointers / deleted files / new files).
- ``*.log``: write-ahead log of ``WriteBatch`` payloads — the un-compacted
  memtable, which a write-once-then-close Caffe packer leaves holding up
  to the last ~4 MB of records.
- ``*.ldb`` / ``*.sst``: block-based tables — prefix-compressed restart
  blocks, an index block of BlockHandles, a 48-byte footer with magic
  0xdb4775248b80fb57; per-block 1-byte compression tag + masked CRC32C.
- Snappy block compression (the LevelDB default): varint preamble +
  literal/copy-tagged elements, decoded in pure Python.

Keys merge newest-sequence-wins across tables and logs (LevelDB's global
sequence ordering), deletions drop the key, and the survivors are exposed
in bytewise key order — the same contract as ``data.lmdb.LmdbReader``, so
``LevelDBFlowDataset`` inherits the whole CustomData decode/permutation
pipeline unchanged.

Write support is NOT provided — the native packer is ``.flowrec``
(data/records.py); this is the migration/read path.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator

from flownet2_tpu_torch.data.lmdb import LmdbFlowDataset

TABLE_MAGIC = 0xDB4775248B80FB57
LOG_BLOCK_SIZE = 32768
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4
_TYPE_DELETION, _TYPE_VALUE = 0, 1
_CRC_MASK_DELTA = 0xA282EAD8


class LevelDBError(ValueError):
    pass


# -- CRC32C (Castagnoli), as used for log records and table blocks ----------

_CRC_TABLE: list = []


def _crc32c(data: bytes, crc: int = 0) -> int:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _CRC_TABLE.append(c)
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _unmask_crc(masked: int) -> int:
    rot = (masked - _CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- varints -----------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise LevelDBError("varint too long")


def _prefixed(buf: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = _varint(buf, pos)
    return buf[pos : pos + n], pos + n


# -- Snappy decompression ----------------------------------------------------


def snappy_decompress(buf: bytes) -> bytes:
    """Decode the (non-framed) Snappy format LevelDB uses for blocks."""
    out_len, pos = _varint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 0x3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:  # 61..64 → length stored in 1..4 trailing bytes
                nbytes = length - 60
                length = int.from_bytes(buf[pos : pos + nbytes], "little") + 1
                pos += nbytes
            out += buf[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise LevelDBError("snappy copy offset out of range")
        start = len(out) - offset
        if offset >= length:  # disjoint — one slice
            out += out[start : start + length]
        else:  # overlapping copy repeats the pattern byte-by-byte
            for i in range(length):
                out.append(out[start + i])
    if len(out) != out_len:
        raise LevelDBError(f"snappy length mismatch: {len(out)} != {out_len}")
    return bytes(out)


# -- log-format files (WAL + MANIFEST) ---------------------------------------


def read_log_records(buf: bytes, *, verify_crc: bool = True) -> list[bytes]:
    """Reassemble the records of a LevelDB log file (32 KiB blocks of
    FULL/FIRST/MIDDLE/LAST fragments, 7-byte headers, zero-padded tails)."""
    records: list[bytes] = []
    frag = bytearray()
    pos, n = 0, len(buf)
    while pos + 7 <= n:
        rem = LOG_BLOCK_SIZE - (pos % LOG_BLOCK_SIZE)
        if rem < 7:
            pos += rem  # block trailer padding
            continue
        crc, length, rtype = struct.unpack_from("<IHB", buf, pos)
        if crc == 0 and length == 0 and rtype == 0:
            pos += rem  # zero-filled (preallocated / clean tail)
            continue
        data = buf[pos + 7 : pos + 7 + length]
        if len(data) < length:
            raise LevelDBError("truncated log record")
        if verify_crc and _crc32c(bytes((rtype,)) + data) != _unmask_crc(crc):
            raise LevelDBError(f"log record CRC mismatch at offset {pos}")
        pos += 7 + length
        if rtype == _FULL:
            records.append(data)
            frag.clear()
        elif rtype == _FIRST:
            frag = bytearray(data)
        elif rtype == _MIDDLE:
            frag += data
        elif rtype == _LAST:
            frag += data
            records.append(bytes(frag))
            frag.clear()
        else:
            raise LevelDBError(f"unknown log record type {rtype}")
    return records


def parse_version_edit(rec: bytes) -> dict:
    """Decode one VersionEdit (the MANIFEST record payload)."""
    edit: dict = {"new_files": [], "deleted_files": []}
    pos = 0
    while pos < len(rec):
        tag, pos = _varint(rec, pos)
        if tag == 1:  # comparator name
            edit["comparator"], pos = _prefixed(rec, pos)
        elif tag == 2:
            edit["log_number"], pos = _varint(rec, pos)
        elif tag == 9:
            edit["prev_log_number"], pos = _varint(rec, pos)
        elif tag == 3:
            edit["next_file_number"], pos = _varint(rec, pos)
        elif tag == 4:
            edit["last_sequence"], pos = _varint(rec, pos)
        elif tag == 5:  # compact pointer: level + internal key
            _, pos = _varint(rec, pos)
            _, pos = _prefixed(rec, pos)
        elif tag == 6:  # deleted file: level + file number
            level, pos = _varint(rec, pos)
            number, pos = _varint(rec, pos)
            edit["deleted_files"].append((level, number))
        elif tag == 7:  # new file: level, number, size, smallest, largest
            level, pos = _varint(rec, pos)
            number, pos = _varint(rec, pos)
            size, pos = _varint(rec, pos)
            _, pos = _prefixed(rec, pos)
            _, pos = _prefixed(rec, pos)
            edit["new_files"].append((level, number, size))
        else:
            raise LevelDBError(f"unknown VersionEdit tag {tag}")
    return edit


def parse_write_batch(rec: bytes):
    """Yield (user_key, sequence, value_type, value) from a WAL record."""
    if len(rec) < 12:
        raise LevelDBError("WriteBatch record too short")
    seq = struct.unpack_from("<Q", rec, 0)[0]
    count = struct.unpack_from("<I", rec, 8)[0]
    pos = 12
    for i in range(count):
        vtype = rec[pos]
        pos += 1
        key, pos = _prefixed(rec, pos)
        if vtype == _TYPE_VALUE:
            value, pos = _prefixed(rec, pos)
        elif vtype == _TYPE_DELETION:
            value = b""
        else:
            raise LevelDBError(f"unknown WriteBatch entry type {vtype}")
        yield key, seq + i, vtype, value


# -- block-based tables (.ldb/.sst) -------------------------------------------


def _block_entries(block: bytes) -> Iterator[tuple[bytes, bytes]]:
    """Iterate a restart-point block's (key, value) entries in order."""
    if len(block) < 4:
        raise LevelDBError("block too short")
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    if data_end < 0:
        raise LevelDBError("bad restart array")
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _read_block(buf, offset: int, size: int, *, verify_crc: bool = True) -> bytes:
    content = bytes(buf[offset : offset + size])
    ctype = buf[offset + size]
    if verify_crc:
        stored = struct.unpack_from("<I", buf, offset + size + 1)[0]
        if _crc32c(content + bytes((ctype,))) != _unmask_crc(stored):
            raise LevelDBError(f"block CRC mismatch at offset {offset}")
    if ctype == 0:
        return content
    if ctype == 1:
        return snappy_decompress(content)
    raise LevelDBError(f"unknown block compression type {ctype}")


def _block_handle(value: bytes) -> tuple[int, int]:
    off, pos = _varint(value, 0)
    size, _ = _varint(value, pos)
    return off, size


class _Table:
    """One .ldb/.sst file: the index block eagerly, data blocks on demand.

    The file itself is memory-mapped, not read: Caffe flow tables run to
    tens of GB and the OS pages in only the blocks actually touched, so
    open() stays O(index + one block) resident — the LmdbReader contract."""

    def __init__(self, path: str, *, verify_crc: bool = True):
        self.path = path
        self.verify_crc = verify_crc
        if os.path.getsize(path) < 48:  # also: mmap rejects empty files
            raise LevelDBError(f"{path}: too short for a table footer")
        self._file = open(path, "rb")
        self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        footer = self._buf[-48:]
        if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
            raise LevelDBError(f"{path}: bad table magic")
        pos = 0
        _, pos = _varint(footer, pos)  # metaindex handle (filters — unused)
        _, pos = _varint(footer, pos)
        idx_off, pos = _varint(footer, pos)
        idx_size, pos = _varint(footer, pos)
        index = _read_block(self._buf, idx_off, idx_size, verify_crc=verify_crc)
        self.handles = [_block_handle(v) for _, v in _block_entries(index)]
        self._cache: tuple[int, list] = (-1, [])

    def entries(self) -> Iterator[tuple[bytes, int, int, int, int]]:
        """Yield (user_key, seq, vtype, block_index, entry_index)."""
        for bi, (off, size) in enumerate(self.handles):
            block = _read_block(self._buf, off, size, verify_crc=self.verify_crc)
            for ei, (ikey, _) in enumerate(_block_entries(block)):
                trailer = struct.unpack("<Q", ikey[-8:])[0]
                yield ikey[:-8], trailer >> 8, trailer & 0xFF, bi, ei

    def value(self, block_index: int, entry_index: int) -> bytes:
        if self._cache[0] != block_index:  # sequential reads decompress once
            off, size = self.handles[block_index]
            block = _read_block(self._buf, off, size, verify_crc=self.verify_crc)
            self._cache = (block_index, [v for _, v in _block_entries(block)])
        return self._cache[1][entry_index]

    def close(self):
        self._cache = (-1, [])
        self._buf.close()
        self._file.close()


# -- the reader ---------------------------------------------------------------


class LevelDBReader:
    """Read-only view of a LevelDB directory, LmdbReader-shaped.

    Recovers the live state the way ``DB::Open`` would: CURRENT → MANIFEST
    VersionEdits (accumulate live table files), load every live table, then
    replay the write-ahead ``*.log`` memtables on top; merge all versions
    of a user key newest-sequence-wins and drop deletions. Values that live
    in tables are fetched lazily per block (one decompression per block for
    sequential access); memtable values are held in memory (bounded by the
    4 MB default write buffer).
    """

    def __init__(self, path: str, *, verify_crc: bool = True):
        path = os.fspath(path)
        if not os.path.isdir(path):
            raise LevelDBError(f"{path}: LevelDB databases are directories")
        self.path = path
        current = os.path.join(path, "CURRENT")
        if not os.path.exists(current):
            raise LevelDBError(f"{path}: no CURRENT file — not a LevelDB")
        with open(current, "rb") as f:
            manifest_name = f.read().strip().decode("ascii")
        manifest = os.path.join(path, manifest_name)
        with open(manifest, "rb") as f:
            manifest_buf = f.read()

        live: dict[int, int] = {}  # file number -> level
        for rec in read_log_records(manifest_buf, verify_crc=verify_crc):
            edit = parse_version_edit(rec)
            for level, number, _size in edit["new_files"]:
                live[number] = level
            for _level, number in edit["deleted_files"]:
                live.pop(number, None)

        # newest wins: (seq, vtype, payload); payload is bytes for memtable
        # entries, (table, block_index, entry_index) for table entries.
        best: dict[bytes, tuple] = {}

        def offer(key, seq, vtype, payload):
            cur = best.get(key)
            if cur is None or seq > cur[0]:
                best[key] = (seq, vtype, payload)

        self._tables: list[_Table] = []
        for number in sorted(live):
            tpath = None
            for ext in ("ldb", "sst"):
                cand = os.path.join(path, f"{number:06d}.{ext}")
                if os.path.exists(cand):
                    tpath = cand
                    break
            if tpath is None:
                raise LevelDBError(f"{path}: live table {number:06d} missing")
            table = _Table(tpath, verify_crc=verify_crc)
            self._tables.append(table)
            for key, seq, vtype, bi, ei in table.entries():
                offer(key, seq, vtype, (table, bi, ei))

        for name in sorted(os.listdir(path)):
            if name.endswith(".log"):
                with open(os.path.join(path, name), "rb") as f:
                    for rec in read_log_records(f.read(), verify_crc=verify_crc):
                        for key, seq, vtype, value in parse_write_batch(rec):
                            offer(key, seq, vtype, value)

        self._keys = sorted(
            k for k, (_seq, vtype, _p) in best.items() if vtype == _TYPE_VALUE
        )
        self._entries = {k: best[k][2] for k in self._keys}

    def __len__(self) -> int:
        return len(self._keys)

    def key(self, i: int) -> bytes:
        return self._keys[i]

    def value(self, i: int) -> bytes:
        payload = self._entries[self._keys[i]]
        if isinstance(payload, bytes):
            return payload
        table, bi, ei = payload
        return table.value(bi, ei)

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        for i in range(len(self)):
            yield self.key(i), self.value(i)

    def close(self):
        for t in self._tables:
            t.close()
        self._tables.clear()
        self._entries.clear()
        self._keys = []


class LevelDBFlowDataset(LmdbFlowDataset):
    """Reference-packed flow LevelDB with the full CustomData decode
    pipeline (slice/encoding decode, label preselection, range subsetting,
    seeded block shuffle) inherited from LmdbFlowDataset."""

    _open = staticmethod(LevelDBReader)
