"""Middlebury ``.flo``, binary PPM/PGM, PFM and KITTI's 16-bit flow PNG
(flownet2_tpu/core/flow_io.py).

Byte-compatible with the JAX package's writers and the reference's
(src/caffe/util/output.cpp:16-96, scripts/run-flownet.py:100-126). Arrays
are channels-last (H, W, C).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

FLO_MAGIC_BYTES = b"PIEH"


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a ``.flo`` file -> float32 (H, W, 2), channels (u, v)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != FLO_MAGIC_BYTES:
            raise ValueError(f"{path}: bad .flo magic {magic!r} (expected {FLO_MAGIC_BYTES!r})")
        width, height = struct.unpack("<ii", f.read(8))
        if width <= 0 or height <= 0 or width * height > 10**8:
            raise ValueError(f"{path}: implausible .flo dims {width}x{height}")
        data = np.fromfile(f, dtype="<f4", count=width * height * 2)
    if data.size != width * height * 2:
        raise ValueError(f"{path}: truncated .flo payload")
    return data.reshape(height, width, 2)


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write (H, W, 2) flow as ``.flo``: magic, w, h, row-major (u, v) float32."""
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(FLO_MAGIC_BYTES)
        f.write(struct.pack("<ii", w, h))
        flow.astype("<f4", copy=False).tofile(f)


def _read_pnm_token(f) -> bytes:
    """One whitespace-delimited header token, skipping '#' comment lines."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            raise ValueError("unexpected EOF in PNM header")
        if c == b"#":
            f.readline()
            continue
        if c.isspace():
            if tok:
                return tok
            continue
        tok += c


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Read binary PPM (P6) / PGM (P5) -> (H, W, 3) or (H, W, 1)."""
    with open(path, "rb") as f:
        magic = f.read(2)
        if magic not in (b"P5", b"P6"):
            raise ValueError(f"{path}: unsupported PNM magic {magic!r}")
        width, height, maxval = (int(_read_pnm_token(f)) for _ in range(3))
        channels = 3 if magic == b"P6" else 1
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        data = np.fromfile(f, dtype=dtype, count=width * height * channels)
    if data.size != width * height * channels:
        raise ValueError(f"{path}: truncated PNM payload")
    return data.reshape(height, width, channels)


def write_ppm(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write uint8 (H, W, 3) as P6 or (H, W[, 1]) as P5."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    with open(path, "wb") as f:
        f.write((b"P6" if c == 3 else b"P5") + b"\n%d %d\n255\n" % (w, h))
        np.clip(img, 0, 255).astype(np.uint8).tofile(f)


def read_pfm(path: str | os.PathLike) -> Tuple[np.ndarray, float]:
    """Read PFM -> (float32 (H, W, C) with row 0 at the top, |scale|).

    PFM stores scanlines bottom to top; the sign of the scale gives the byte
    order (negative: little-endian). The reference uses it for disparity and
    FlyingThings3D flow (tools/convert_imageset_and_disparity.cpp)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file (magic {magic!r})")
        channels = 3 if magic == b"PF" else 1
        width, height = (int(v) for v in f.readline().split()[:2])
        scale = float(f.readline().strip())
        data = np.fromfile(f, dtype=("<" if scale < 0 else ">") + "f4", count=width * height * channels)
    if data.size != width * height * channels:
        raise ValueError(f"{path}: truncated PFM payload")
    return np.ascontiguousarray(data.reshape(height, width, channels)[::-1]), abs(scale)


def write_pfm(path: str | os.PathLike, img: np.ndarray, scale: float = 1.0) -> None:
    """Write float32 (H, W[, C]) as PFM, C 1 or 3 (little-endian, bottom-to-top rows)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"PFM supports 1 or 3 channels, got {c}")
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(b"%d %d\n" % (w, h))
        f.write(b"%f\n" % -abs(scale))
        img[::-1].astype("<f4").tofile(f)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter_rows(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) -> uint8 (H, stride).

    None, Sub and Up are whole-row numpy operations; Average and Paeth
    depend on the pixel just reconstructed to the left, so those rows run a
    loop over bytes."""
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png16_rgb(path: str | os.PathLike) -> np.ndarray:
    """Read a non-interlaced 16-bit RGB PNG -> uint16 (H, W, 3), decoded with
    zlib and numpy, all 16 bits kept (Pillow cuts such files to 8 bits a
    channel). Other PNG kinds raise."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8 : pos + 8 + length]
        if len(data) != length:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + data) != struct.unpack_from(">I", buf, pos + 8 + length)[0]:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (16, 2, 0):
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, color type {color}, interlace {interlace}; "
            "only non-interlaced 16-bit RGB (KITTI's flow maps) is read here"
        )
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * 6 + 1):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, expected {height * (width * 6 + 1)}")
    rows = _unfilter_rows(raw, height, width * 6, 6)
    return rows.view(">u2").reshape(height, width, 3).astype(np.uint16)


def read_kitti_flow(path: str | os.PathLike) -> np.ndarray:
    """KITTI's flow map -> float32 (H, W, 2): (value - 2^15) / 64 per channel,
    NaN where channel 2 (the valid flag) is 0 (the KITTI devkit's
    readFlowField, and the reference's NaN-invalid convention)."""
    png = read_png16_rgb(path)
    flow = (png[..., :2].astype(np.float32) - 2**15) / 64.0
    flow[png[..., 2] == 0] = np.nan
    return flow


def read_image(path: str | os.PathLike) -> np.ndarray:
    """Read an image -> uint8 (H, W, 3) RGB: PPM/PGM natively, other formats
    through PIL where it is installed; grayscale is broadcast to 3 channels."""
    path = os.fspath(path)
    if os.path.splitext(path)[1].lower() in (".ppm", ".pgm", ".pnm"):
        img = read_ppm(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"cannot decode {path} without PIL; convert it to .ppm first") from e
        img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img
