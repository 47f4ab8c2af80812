"""Packed flow records (the port's copy of flownet2_tpu/data/records.py): the
LMDB-free equivalent of the reference's datum packing
(tools/convert_imageset_and_flow.cpp:142-240).

On-disk record payload keeps the reference's exact channel encoding so data
round-trips losslessly between both frameworks' converters:

- img0, img1: 3-channel uint8 each;
- flow: 2-channel int16 fixed point (value = flow×32, NaN → SHRT_MAX);
- optional occlusion: 1 bit/pixel, little-endian bit order.

Container: a flat ``.flowrec`` file of length-prefixed records plus a
``.flowrec.idx`` int64 offset table (seekable random access — the role
LMDB's B-tree played, without the dependency). Header per record:
``H (u32) | W (u32) | flags (u32)`` with flag bit 0 = has-occlusion and
bit 1 = a 1-channel (disparity) payload. Files are byte-for-byte those of
the JAX package's writer. Transport items are numpy views of the record;
float items decode through the native decoder (``data/native.py``), as the
JAX reader's do, and :func:`decode_body` is its numpy plain version.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from flownet2_tpu_torch.core.codec import (
    decode_flow_int16,
    decode_occlusion_bits,
    encode_flow_int16,
    encode_occlusion_bits,
)
from flownet2_tpu_torch.data import native

MAGIC = b"FLR1"
_FLAG_OCC = 1
_FLAG_DISPARITY = 2  # "flow" payload has 1 channel (stereo disparity)


class FlowRecordWriter:
    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._offsets: list[int] = []

    def write(
        self,
        img0: np.ndarray,
        img1: np.ndarray,
        flow: np.ndarray,
        occ: Optional[np.ndarray] = None,
    ) -> None:
        h, w = img0.shape[:2]
        if img1.shape[:2] != (h, w) or flow.shape[:2] != (h, w):
            raise ValueError("img0/img1/flow dimensions must match")
        if flow.ndim == 2:
            flow = flow[..., None]
        n_flow_ch = flow.shape[-1]
        if n_flow_ch not in (1, 2):
            raise ValueError("flow/disparity payload must have 1 or 2 channels")
        flags = (_FLAG_OCC if occ is not None else 0) | (
            _FLAG_DISPARITY if n_flow_ch == 1 else 0
        )
        payload = [
            np.ascontiguousarray(img0[..., :3], dtype=np.uint8).tobytes(),
            np.ascontiguousarray(img1[..., :3], dtype=np.uint8).tobytes(),
            encode_flow_int16(flow[..., :n_flow_ch]).tobytes(),
        ]
        if occ is not None:
            payload.append(encode_occlusion_bits(occ).tobytes())
        body = struct.pack("<III", h, w, flags) + b"".join(payload)
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<Q", len(body)))
        self._f.write(body)

    def close(self) -> None:
        self._f.close()
        with open(self.path + ".idx", "wb") as f:
            f.write(struct.pack("<Q", len(self._offsets)))
            np.asarray(self._offsets, "<i8").tofile(f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode_body(body: bytes, *, transport: bool) -> dict:
    """A record body decoded with numpy: in the transport domain, uint8
    images, int16 flow and uint8 occlusion as views of ``body`` (no copy);
    else float32 arrays, flow with NaN where invalid, the plain version of
    :func:`~flownet2_tpu_torch.data.native.decode_record`."""
    h, w, flags = struct.unpack_from("<III", body, 0)
    off = 12
    n_img = h * w * 3
    img0 = np.frombuffer(body, np.uint8, n_img, off).reshape(h, w, 3)
    off += n_img
    img1 = np.frombuffer(body, np.uint8, n_img, off).reshape(h, w, 3)
    off += n_img
    n_flow_ch = 1 if flags & _FLAG_DISPARITY else 2
    flow_i16 = np.frombuffer(body, np.int16, h * w * n_flow_ch, off).reshape(h, w, n_flow_ch)
    off += h * w * n_flow_ch * 2
    if transport:
        out = {"img0": img0, "img1": img1, "flow": flow_i16}
    else:
        out = {
            "img0": img0.astype(np.float32),
            "img1": img1.astype(np.float32),
            "flow": decode_flow_int16(flow_i16),
        }
    if flags & _FLAG_OCC:
        n_occ = (h * w + 7) // 8
        occ = decode_occlusion_bits(np.frombuffer(body, np.uint8, n_occ, off), (h, w))
        out["occ"] = occ.astype(np.uint8 if transport else np.float32)[..., None]
    return out


class FlowRecordReader:
    """Random-access reader; an item loads to the same dict shape as
    FlowPairDataset items (float32 HWC arrays, flow with NaN invalids).

    ``transport=True`` keeps items in the on-disk TRANSPORT domain instead:
    uint8 images and int16 fixed-point flow, zero host decode (the arrays
    are raw views of the record body). Batches built from transport items
    upload 3.2× fewer host→device bytes; the objectives decode them on the
    batch's device (core/codec.flow_as_f32) — the division of labor of the
    reference's UINT16FLOW datums, which stay fixed-point until the data
    layer's device-side decode (custom_data_layer.cpp:94-112).
    """

    def __init__(self, path: str, *, transport: bool = False):
        self.path = os.fspath(path)
        self.transport = transport
        self._f = open(self.path, "rb")
        if self._f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a .flowrec file")
        with open(self.path + ".idx", "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            self._offsets = np.fromfile(f, "<i8", count=n)

    def __len__(self) -> int:
        return len(self._offsets)

    def body(self, i: int) -> bytes:
        """Record i's raw body: header and payload."""
        # os.pread: ATOMIC positioned read. BatchLoader runs multiple worker
        # threads over one reader; a shared-handle seek()+read() interleaves
        # across threads and yields torn records (observed: shape errors —
        # and a torn read whose length field still parses would be silent
        # data corruption). pread has no shared file position, so the reader
        # is thread-safe without locking (the reference serializes through
        # its DataReader queue instead, data_reader.cpp:22-79).
        fd = self._f.fileno()
        off = int(self._offsets[i])
        (length,) = struct.unpack("<Q", os.pread(fd, 8, off))
        return os.pread(fd, length, off + 8)

    def __getitem__(self, i: int) -> dict:
        body = self.body(i)
        if self.transport:
            return decode_body(body, transport=True)
        try:  # float domain: the native decoder (native/flowdata.cc)
            return native.decode_record(body)
        except ValueError as e:
            raise ValueError(f"{self.path}[{i}]: {e}") from None

    def close(self):
        self._f.close()

    # -- loader-protocol extras (mirror FlowPairDataset) -------------------

    def permutation(self, seed, block_size: int = 1) -> np.ndarray:
        """Seeded block-wise shuffle (the CustomData rand_permute/block_size
        options, custom_data_layer.cpp:29-42) for BatchLoader."""
        n = len(self)
        if seed is None:
            return np.arange(n)
        rng = np.random.default_rng(seed)
        n_blocks = (n + block_size - 1) // block_size
        order = rng.permutation(n_blocks)
        idx = []
        for b in order:
            lo = int(b) * block_size
            idx.extend(range(lo, min(lo + block_size, n)))
        return np.asarray(idx)
