"""Pure-Python LMDB read compatibility + the CustomData datum decode (the
port's copy of flownet2_tpu/data/lmdb.py).

The reference's entire training data path is LMDB
(custom_data_layer.cpp:139-305, util/db_lmdb.cpp); datasets packed by its
``convert_imageset_and_flow`` tool (SURVEY.md §2.5) are therefore the
installed base. This module makes those files drop-in readable WITHOUT the
liblmdb dependency: a read-only B+tree walker over the standard
``data.mdb`` format, a clean-room Datum protobuf parser, and the
CustomData channel-slice decode (slice_point / UINT8 / UINT16FLOW / BOOL1,
custom_data_layer.cpp:60-132), plus the layer's permutation machinery
(preselection-by-label, range subsetting, seeded block shuffle —
custom_data_layer.cpp:394-476).

LMDB on-disk layout implemented (mdb.c data structures, stable since
format version 1): 16-byte page headers; meta pages 0/1 (pick larger
txnid; page size from mm_dbs[FREE].md_pad); branch/leaf node arrays of
u16 in-page offsets; F_BIGDATA values in contiguous overflow pages.
Write support is NOT provided — the native packer is ``.flowrec``
(data/records.py); this is the migration/read path.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

import numpy as np

from flownet2_tpu_torch.core.codec import decode_flow_int16, decode_occlusion_bits

PAGEHDRSZ = 16
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_LEAF2 = 0x20
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE


class LmdbError(ValueError):
    pass


class LmdbReader:
    """Read-only cursor over an LMDB environment's main database.

    ``path`` may be the environment directory (containing ``data.mdb``) or
    the .mdb file itself. Entries are exposed in key order (LMDB keys are
    sorted; the reference writes zero-padded decimal indices so key order
    IS index order, convert_imageset_and_flow.cpp:227-240).
    """

    def __init__(self, path: str):
        path = os.fspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(0, os.SEEK_END)
        self._size = self._f.tell()

        # Meta page 1 lives at file offset == page size; probe the common
        # sizes (environments created with a non-default psize put meta1 at
        # that psize, and the meta itself records the true value).
        meta = None
        for probe in (4096, 8192, 16384, 32768, 65536, 1024, 2048, 512):
            m0 = self._read_meta(0, probe)
            m1 = self._read_meta(1, probe)
            if m1 is not None and (m0 is None or m1["txnid"] > m0["txnid"]):
                m0 = m1
            if m0 is not None and m0["psize"] == probe:
                meta = m0
                break
        if meta is None:
            raise LmdbError(
                f"{path}: no valid LMDB meta page (probed page sizes "
                "512..65536)"
            )
        self.psize = meta["psize"]
        self.n_entries = meta["entries"]
        self._root = meta["root"]
        # index: (key, value_bytes | (overflow_pgno, size))
        self._index: list[tuple[bytes, object]] = []
        if self._root != 0xFFFFFFFFFFFFFFFF:  # P_INVALID = empty db
            self._walk(self._root)
        if len(self._index) != self.n_entries:
            raise LmdbError(
                f"{path}: walked {len(self._index)} entries, meta says {self.n_entries}"
            )

    # -- file primitives ----------------------------------------------------

    def _read_meta(self, pageno: int, psize: int = 4096) -> Optional[dict]:
        # Meta layout after the 16B page header: magic u32, version u32,
        # address u64, mapsize u64, mm_dbs[2] (48B each: pad u32, flags u16,
        # depth u16, branch/leaf/overflow pages u64 x3, entries u64, root
        # u64), last_pg u64, txnid u64. psize lives in mm_dbs[0].md_pad.
        base = pageno * psize
        self._f.seek(base)
        raw = self._f.read(psize)
        if len(raw) < PAGEHDRSZ + 120:
            return None
        magic, version = struct.unpack_from("<II", raw, PAGEHDRSZ)
        if magic != MDB_MAGIC:
            return None
        psize = struct.unpack_from("<I", raw, PAGEHDRSZ + 24)[0]
        main = PAGEHDRSZ + 24 + 48  # mm_dbs[MAIN_DBI]
        entries, root = struct.unpack_from("<QQ", raw, main + 32)
        txnid = struct.unpack_from("<Q", raw, main + 48 + 8)[0]
        return {"psize": psize, "entries": entries, "root": root, "txnid": txnid}

    def _page(self, pgno: int, npages: int = 1) -> bytes:
        off = pgno * self.psize
        if off + npages * self.psize > self._size:
            raise LmdbError(f"{self.path}: page {pgno} out of bounds")
        self._f.seek(off)
        return self._f.read(npages * self.psize)

    # -- B+tree walk ----------------------------------------------------------

    def _walk(self, pgno: int) -> None:
        raw = self._page(pgno)
        flags, lower = struct.unpack_from("<HH", raw, 10)
        n_nodes = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n_nodes}H", raw, PAGEHDRSZ)
        if flags & P_LEAF2:
            raise LmdbError("MDB_DUPFIXED (LEAF2) databases are not supported")
        if flags & P_BRANCH:
            for p in ptrs:
                lo, hi, nflags = struct.unpack_from("<HHH", raw, p)
                child = lo | (hi << 16) | (nflags << 32)
                self._walk(child)
            return
        if not flags & P_LEAF:
            raise LmdbError(f"{self.path}: page {pgno} is not branch/leaf (flags={flags:#x})")
        for p in ptrs:
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", raw, p)
            datasize = lo | (hi << 16)
            key = raw[p + 8 : p + 8 + ksize]
            if nflags & F_BIGDATA:
                (ov_pgno,) = struct.unpack_from("<Q", raw, p + 8 + ksize)
                self._index.append((key, (int(ov_pgno), datasize)))
            else:
                val = raw[p + 8 + ksize : p + 8 + ksize + datasize]
                self._index.append((key, val))

    # -- public API -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def key(self, i: int) -> bytes:
        return self._index[i][0]

    def value(self, i: int) -> bytes:
        v = self._index[i][1]
        if isinstance(v, tuple):  # overflow: contiguous pages, data after hdr
            ov_pgno, size = v
            npages = (PAGEHDRSZ + size + self.psize - 1) // self.psize
            raw = self._page(ov_pgno, npages)
            return raw[PAGEHDRSZ : PAGEHDRSZ + size]
        return v

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        for i in range(len(self)):
            yield self.key(i), self.value(i)

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# Datum protobuf (clean-room wire parser; message caffe.proto Datum)
# ---------------------------------------------------------------------------


def parse_datum(buf: bytes, *, skip_data: bool = False) -> dict:
    """Parse a caffe Datum: channels=1, height=2, width=3, data=4 (bytes),
    label=5, float_data=6 (repeated float), encoded=7.

    ``skip_data=True`` walks past length-delimited payloads (the image/flow
    blob, field 4, and packed float_data) without materializing them —
    O(header varints) per record, for label scans (the reference avoids the
    same cost with a separate preselection file, custom_data_layer.cpp:394-476).
    """
    out = {"channels": 0, "height": 0, "width": 0, "data": b"", "label": 0,
           "float_data": [], "encoded": False}
    i, n = 0, len(buf)

    def varint():
        nonlocal i
        shift = v = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while i < n:
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v = varint()
            if field == 1:
                out["channels"] = v
            elif field == 2:
                out["height"] = v
            elif field == 3:
                out["width"] = v
            elif field == 5:
                out["label"] = v - (1 << 64) if v >= 1 << 63 else v
            elif field == 7:
                out["encoded"] = bool(v)
        elif wire == 2:
            ln = varint()
            if skip_data:
                i += ln
                continue
            chunk = buf[i : i + ln]
            i += ln
            if field == 4:
                out["data"] = chunk
            elif field == 6:  # packed floats
                out["float_data"].extend(
                    struct.unpack(f"<{ln // 4}f", chunk)
                )
        elif wire == 5:
            if field == 6:
                out["float_data"].append(struct.unpack_from("<f", buf, i)[0])
            i += 4
        elif wire == 1:
            i += 8
        else:
            raise LmdbError(f"unsupported wire type {wire} in Datum")
    return out


# ---------------------------------------------------------------------------
# CustomData channel-slice decode (custom_data_layer.cpp:60-132)
# ---------------------------------------------------------------------------

UINT8, UINT16FLOW, BOOL1 = "UINT8", "UINT16FLOW", "BOOL1"

# the reference flow-LMDB packing (convert_imageset_and_flow.cpp:142-206)
FLOW_SLICE_POINTS = (3, 6, 8)
FLOW_ENCODINGS = (UINT8, UINT8, UINT16FLOW, BOOL1)
# disparity packing (convert_imageset_and_disparity.cpp): 1-channel disparity
DISPARITY_SLICE_POINTS = (3, 6, 7)
DISPARITY_ENCODINGS = (UINT8, UINT8, UINT16FLOW, BOOL1)


def decode_custom_datum(
    datum: dict,
    slice_points: tuple[int, ...] = FLOW_SLICE_POINTS,
    encodings: tuple[str, ...] = FLOW_ENCODINGS,
) -> list[np.ndarray]:
    """Split one datum into per-slice (C, H, W) float32 arrays, exactly the
    reference switch: UINT8 raw bytes; UINT16FLOW little-endian int16/32
    with SHRT_MAX→NaN; BOOL1 bit-packed, one bitmap PER CHANNEL row-major
    LSB-first (custom_data_layer.cpp:94-128)."""
    c, h, w = datum["channels"], datum["height"], datum["width"]
    buf = datum["data"]
    bounds = [0, *slice_points, c]
    if sorted(slice_points) != list(slice_points) or (slice_points and slice_points[-1] > c):
        raise LmdbError(f"bad slice_points {slice_points} for {c} channels")
    out = []
    off = 0
    for s in range(len(bounds) - 1):
        nch = bounds[s + 1] - bounds[s]
        enc = encodings[s] if s < len(encodings) else UINT8
        if enc == UINT8:
            n = nch * h * w
            arr = np.frombuffer(buf, np.uint8, n, off).astype(np.float32)
            off += n
            out.append(arr.reshape(nch, h, w))
        elif enc == UINT16FLOW:
            n = nch * h * w
            raw = np.frombuffer(buf, "<i2", n, off).reshape(nch, h, w)
            off += 2 * n
            out.append(decode_flow_int16(raw))
        elif enc == BOOL1:
            nbytes = (h * w - 1) // 8 + 1
            chans = []
            for _ in range(nch):
                bits = np.frombuffer(buf, np.uint8, nbytes, off)
                off += nbytes
                chans.append(decode_occlusion_bits(bits, (h, w)).astype(np.float32))
            out.append(np.stack(chans, axis=0))
        else:
            raise LmdbError(f"invalid encoding {enc!r} for slice {s}")
    return out


class LmdbFlowDataset:
    """Reference-packed flow LMDB as a FlowPairDataset-protocol dataset.

    Items decode to {img0, img1, flow[, occ]} float32 HWC arrays — the same
    contract as data/records.FlowRecordReader — including the BGR→RGB flip
    (the reference packs OpenCV BGR; this framework is RGB end to end, with
    the flip otherwise handled by the caffemodel importer's conv1 swap).
    """

    _open = staticmethod(LmdbReader)

    def __init__(
        self,
        path: str,
        *,
        slice_points: tuple[int, ...] = FLOW_SLICE_POINTS,
        encodings: tuple[str, ...] = FLOW_ENCODINGS,
        bgr_to_rgb: bool = True,
    ):
        # _open is the backend hook: data.leveldb.LevelDBFlowDataset swaps
        # in LevelDBReader and inherits the whole decode/permutation path.
        self.db = self._open(path)
        self.slice_points = tuple(slice_points)
        self.encodings = tuple(encodings)
        self.bgr_to_rgb = bgr_to_rgb

    def __len__(self) -> int:
        return len(self.db)

    def __getitem__(self, i: int) -> dict:
        datum = parse_datum(self.db.value(i))
        slices = decode_custom_datum(datum, self.slice_points, self.encodings)
        chw = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -1))
        img0, img1 = chw(slices[0]), chw(slices[1])
        if self.bgr_to_rgb:
            img0, img1 = img0[..., ::-1].copy(), img1[..., ::-1].copy()
        out = {"img0": img0, "img1": img1, "flow": chw(slices[2])}
        if len(slices) > 3:
            out["occ"] = chw(slices[3])
        out["label"] = datum["label"]
        return out

    def labels(self) -> np.ndarray:
        """All labels. Cheap: the datum parse skips every length-delimited
        payload (the image/flow blob is never sliced or decoded), so a label
        scan is O(records), not O(dataset-bytes)."""
        return np.asarray(
            [
                parse_datum(self.db.value(i), skip_data=True)["label"]
                for i in range(len(self))
            ]
        )

    def permutation(
        self,
        seed=None,
        block_size: int = 1,
        *,
        preselection_labels: Optional[np.ndarray] = None,
        preselection_label: Optional[int] = None,
        range_start: int = 0,
        range_end: int = -1,
        order: str = "first_permute_then_range",
    ) -> np.ndarray:
        """The CustomData index pipeline (custom_data_layer.cpp:394-476):
        preselection-by-label → {permute, range} in either order.

        ``preselection_labels``: one label per entry (the preselection_file
        contents); entries whose label != preselection_label are dropped.
        ``seed=None`` disables shuffling (rand_permute false).
        """
        if preselection_label is not None:
            labels = (
                np.asarray(preselection_labels)
                if preselection_labels is not None
                else self.labels()
            )
            if len(labels) != len(self):
                raise LmdbError(
                    f"preselection has {len(labels)} labels, db has {len(self)} entries"
                )
            perm = np.flatnonzero(labels == preselection_label)
        else:
            perm = np.arange(len(self))

        def cut_range(p):
            start = min(max(range_start, 0), len(p) - 1)
            end = len(p) - 1 if range_end < 0 or range_end >= len(p) else range_end
            if end < start:
                raise LmdbError("range end is before start")
            return p[start : end + 1]

        def shuffle(p):
            if seed is None:
                return p
            rng = np.random.default_rng(seed)
            n_blocks = (len(p) + block_size - 1) // block_size
            idx = []
            for b in rng.permutation(n_blocks):
                lo = int(b) * block_size
                idx.extend(range(lo, min(lo + block_size, len(p))))
            return p[np.asarray(idx, np.int64)]

        if order == "first_permute_then_range":
            return cut_range(shuffle(perm))
        elif order == "first_range_then_permute":
            return shuffle(cut_range(perm))
        raise LmdbError(f"unknown rand_permute_order {order!r}")
