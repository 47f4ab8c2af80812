"""Minimal pure-Python HDF5 reader/writer for caffe ``.caffemodel.h5`` files
(the port's copy of flownet2_tpu/core/hdf5_lite.py).

h5py is not a dependency, and the reference saves/loads
weights as HDF5 (net.cpp:752-885 ToHDF5/FromHDF5: groups ``/data/<layer>``
with datasets ``0``, ``1``, ... per parameter blob). Caffe links libhdf5 1.8
with default property lists, which produces the classic on-disk format:
version-0 superblock, symbol-table (v1 B-tree + local heap + SNOD) groups,
version-1 object headers, and contiguous dataset layout. This module
implements exactly that subset — enough to read any caffe-written weight
file and to write files that libhdf5/h5py read back:

  read_hdf5(path)  -> nested dict {group: {...: np.ndarray}}
  write_hdf5(path, tree)

Unsupported features (chunked/compressed layout, v2+ superblocks or object
headers, non-float/int types) raise informative errors rather than
mis-parsing. The format details follow the public HDF5 File Format
Specification (Version 2.0), not any HDF5 library code.
"""

from __future__ import annotations

import struct
from typing import Union

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

Tree = dict  # nested {str: Tree | np.ndarray}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.b = buf
        if buf[:8] != _SIG:
            raise ValueError("not an HDF5 file (bad signature)")
        ver = buf[8]
        if ver != 0:
            raise NotImplementedError(
                f"HDF5 superblock version {ver} not supported (caffe writes v0); "
                "convert with h5repack or h5py elsewhere"
            )
        self.size_offsets = buf[13]
        self.size_lengths = buf[14]
        if (self.size_offsets, self.size_lengths) != (8, 8):
            raise NotImplementedError("only 8-byte offsets/lengths supported")
        # v0 superblock: 24 fixed bytes then 4 addresses then root symbol entry
        base = struct.unpack_from("<Q", buf, 24)[0]
        if base != 0:
            raise NotImplementedError("nonzero base address")
        # root group symbol-table entry at offset 24 + 4*8
        self.root_header = struct.unpack_from("<Q", buf, 24 + 32 + 8)[0]

    def u(self, fmt, off):
        return struct.unpack_from(fmt, self.b, off)

    # -- object header ------------------------------------------------------

    def read_object_header(self, addr: int) -> list[tuple[int, bytes]]:
        """Return [(msg_type, body)] for a v1 object header, following
        continuation messages."""
        version, _, nmsgs, _refs, hsize = self.u("<BBHIi", addr)
        if version != 1:
            raise NotImplementedError(f"object header version {version}")
        msgs: list[tuple[int, bytes]] = []
        # messages start after the 12-byte prefix + 4 pad bytes
        blocks = [(addr + 16, hsize)]
        while blocks and len(msgs) < nmsgs:
            pos, remaining = blocks.pop(0)
            end = pos + remaining
            while pos + 8 <= end and len(msgs) < nmsgs:
                mtype, msize, _flags = self.u("<HHB", pos)
                body = self.b[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x0010:  # continuation
                    caddr, clen = struct.unpack_from("<QQ", body, 0)
                    blocks.append((caddr, clen))
                    continue
                msgs.append((mtype, bytes(body)))
        return msgs

    # -- groups --------------------------------------------------------------

    def read_group(self, header_addr: int) -> Tree:
        msgs = self.read_object_header(header_addr)
        stab = [m for t, m in msgs if t == 0x0011]
        if stab:
            btree_addr, heap_addr = struct.unpack_from("<QQ", stab[0], 0)
            return self._read_symbol_table(btree_addr, heap_addr)
        # dataset?
        return self._read_dataset(msgs)

    def _heap_string(self, heap_addr: int, offset: int) -> str:
        if self.b[heap_addr : heap_addr + 4] != b"HEAP":
            raise ValueError("bad local heap signature")
        data_addr = struct.unpack_from("<Q", self.b, heap_addr + 24)[0]
        start = data_addr + offset
        endp = self.b.index(b"\x00", start)
        return self.b[start:endp].decode()

    def _read_symbol_table(self, btree_addr: int, heap_addr: int) -> Tree:
        out: Tree = {}
        for snod_addr in self._btree_children(btree_addr):
            if self.b[snod_addr : snod_addr + 4] != b"SNOD":
                raise ValueError("bad SNOD signature")
            nsyms = struct.unpack_from("<H", self.b, snod_addr + 6)[0]
            pos = snod_addr + 8
            for _ in range(nsyms):
                name_off, obj_addr = struct.unpack_from("<QQ", self.b, pos)
                name = self._heap_string(heap_addr, name_off)
                out[name] = self.read_group(obj_addr)
                pos += 40
        return out

    def _btree_children(self, addr: int) -> list[int]:
        if self.b[addr : addr + 4] != b"TREE":
            raise ValueError("bad B-tree signature")
        ntype, level, used = self.u("<BBH", addr + 4)
        if ntype != 0:
            raise ValueError("not a group B-tree")
        children = []
        pos = addr + 8 + 16  # skip siblings
        pos += 8  # key 0
        for _ in range(used):
            child = struct.unpack_from("<Q", self.b, pos)[0]
            pos += 16  # child + next key
            if level == 0:
                children.append(child)
            else:
                children.extend(self._btree_children(child))
        return children

    # -- datasets -------------------------------------------------------------

    def _read_dataset(self, msgs) -> np.ndarray:
        dims = dtype = None
        data_addr = data_size = None
        compact = None
        for mtype, body in msgs:
            if mtype == 0x0001:  # dataspace
                version, rank, flags = struct.unpack_from("<BBB", body, 0)
                if version == 1:
                    off = 8
                elif version == 2:
                    off = 4
                else:
                    raise NotImplementedError(f"dataspace v{version}")
                dims = struct.unpack_from(f"<{rank}Q", body, off)
            elif mtype == 0x0003:  # datatype
                dtype = self._parse_datatype(body)
            elif mtype == 0x0008:  # layout
                version = body[0]
                if version == 3:
                    cls = body[1]
                    if cls == 1:  # contiguous
                        data_addr, data_size = struct.unpack_from("<QQ", body, 2)
                    elif cls == 0:  # compact
                        csize = struct.unpack_from("<H", body, 2)[0]
                        compact = body[4 : 4 + csize]
                    else:
                        raise NotImplementedError(
                            "chunked datasets not supported (caffe writes contiguous)"
                        )
                elif version in (1, 2):
                    rank = body[1]
                    cls = body[2]
                    if cls != 1:
                        raise NotImplementedError("only contiguous v1/v2 layout")
                    data_addr = struct.unpack_from("<Q", body, 8)[0]
                else:
                    raise NotImplementedError(f"layout v{version}")
        if dims is None or dtype is None:
            raise ValueError("object is neither group nor dataset")
        count = int(np.prod(dims)) if dims else 1
        if compact is not None:
            raw = compact
        elif data_addr is None or data_addr == _UNDEF:
            return np.zeros(dims, dtype)  # never-written dataset
        else:
            raw = self.b[data_addr : data_addr + count * dtype.itemsize]
        return np.frombuffer(raw, dtype, count).reshape(dims).copy()

    @staticmethod
    def _parse_datatype(body: bytes) -> np.dtype:
        cls_ver = body[0]
        cls = cls_ver & 0x0F
        bits0 = body[1]
        size = struct.unpack_from("<I", body, 4)[0]
        le = not (bits0 & 1)
        bo = "<" if le else ">"
        if cls == 1:  # float
            return np.dtype(f"{bo}f{size}")
        if cls == 0:  # fixed-point
            signed = bool(bits0 & 0x08)
            return np.dtype(f"{bo}{'i' if signed else 'u'}{size}")
        raise NotImplementedError(f"datatype class {cls}")


def read_hdf5(path_or_bytes: Union[str, bytes]) -> Tree:
    """Parse an HDF5 file into nested dicts of numpy arrays."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    r = _Reader(buf)
    return r.read_group(r.root_header)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self):
        self.buf = bytearray(b"\x00" * 2048)  # superblock placeholder region

    def align(self, n=8):
        while len(self.buf) % n:
            self.buf += b"\x00"

    def alloc(self, data: bytes) -> int:
        self.align()
        addr = len(self.buf)
        self.buf += data
        return addr

    def write_dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            dt_body = self._float_dtype(8)
        elif arr.dtype == np.float32:
            dt_body = self._float_dtype(4)
        elif arr.dtype in (np.dtype("<i4"), np.dtype("<i8"), np.dtype("<u1")):
            dt_body = self._int_dtype(arr.dtype)
        else:
            arr = arr.astype(np.float32)
            dt_body = self._float_dtype(4)
        data_addr = self.alloc(arr.tobytes())
        rank = arr.ndim
        ds_body = struct.pack("<BBBBI", 1, rank, 0, 0, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape
        )
        layout_body = struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)
        msgs = [(0x0001, ds_body), (0x0003, dt_body), (0x0008, layout_body)]
        return self._object_header(msgs)

    @staticmethod
    def _float_dtype(size: int) -> bytes:
        if size == 4:
            return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 0x1F, 0x00, 4, 0, 32, 23, 8, 0, 23, 127)
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 0x3F, 0x00, 8, 0, 64, 52, 11, 0, 52, 1023)

    @staticmethod
    def _int_dtype(dt: np.dtype) -> bytes:
        signed = 0x08 if dt.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, dt.itemsize, 0, dt.itemsize * 8)

    def _object_header(self, msgs: list[tuple[int, bytes]]) -> int:
        parts = b""
        for mtype, body in msgs:
            pad = (-len(body)) % 8
            parts += struct.pack("<HHBBBB", mtype, len(body) + pad, 0, 0, 0, 0)
            parts += body + b"\x00" * pad
        header = struct.pack("<BBHIi", 1, 0, len(msgs), 1, len(parts)) + b"\x00" * 4 + parts
        return self.alloc(header)

    def write_group(self, tree: Tree) -> int:
        # children first
        entries = []
        for name in sorted(tree):
            child = tree[name]
            if isinstance(child, dict):
                addr = self.write_group(child)
            else:
                addr = self.write_dataset(np.asarray(child))
            entries.append((name, addr))
        # local heap: name strings
        heap_data = bytearray(b"\x00" * 8)  # offset 0: empty string slot
        offs = []
        for name, _ in entries:
            offs.append(len(heap_data))
            heap_data += name.encode() + b"\x00"
            while len(heap_data) % 8:
                heap_data += b"\x00"
        heap_data_addr = self.alloc(bytes(heap_data))
        heap_hdr = b"HEAP" + struct.pack(
            "<BBBBQQQ", 0, 0, 0, 0, len(heap_data), 1, heap_data_addr
        )
        heap_addr = self.alloc(heap_hdr)
        # single SNOD with all (sorted) entries
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(entries))
        for (name, addr), off in zip(entries, offs):
            snod += struct.pack("<QQII", off, addr, 0, 0) + b"\x00" * 16
        snod_addr = self.alloc(snod)
        # B-tree: one leaf child
        last_key = offs[-1] if offs else 0
        btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
        btree += struct.pack("<QQQ", 0, snod_addr, last_key)
        btree_addr = self.alloc(btree)
        stab_body = struct.pack("<QQ", btree_addr, heap_addr)
        return self._object_header([(0x0011, stab_body)])

    def finish(self, root_addr: int, root_btree_heap: tuple[int, int]) -> bytes:
        sb = bytearray()
        sb += _SIG
        sb += struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
        sb += struct.pack("<HH", 1024, 16)  # leaf k (large: single-SNOD groups), internal k
        sb += struct.pack("<I", 0)
        sb += struct.pack("<QQQQ", 0, _UNDEF, len(self.buf), _UNDEF)
        # root symbol table entry
        btree_addr, heap_addr = root_btree_heap
        sb += struct.pack("<QQII", 0, root_addr, 1, 0)
        sb += struct.pack("<QQ", btree_addr, heap_addr)
        self.buf[: len(sb)] = sb
        return bytes(self.buf)


def write_hdf5(path: str | None, tree: Tree) -> bytes:
    """Write nested dicts of numpy arrays as a classic-format HDF5 file."""
    w = _Writer()
    root_addr = w.write_group(tree)
    # recover the root's btree/heap addresses from its symbol-table message
    buf = bytes(w.buf)
    version, _, nmsgs, _refs, hsize = struct.unpack_from("<BBHIi", buf, root_addr)
    pos = root_addr + 16
    btree_addr = heap_addr = 0
    for _ in range(nmsgs):
        mtype, msize = struct.unpack_from("<HH", buf, pos)
        if mtype == 0x0011:
            btree_addr, heap_addr = struct.unpack_from("<QQ", buf, pos + 8)
        pos += 8 + msize
    out = w.finish(root_addr, (btree_addr, heap_addr))
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out
