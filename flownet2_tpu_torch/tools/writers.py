"""Artifact writers (flownet2_tpu/tools/writers.py): the reference's
FLOWriter/ImgWriter/FloatWriter/PFMWriter layers as a host-side sink.

Reference semantics (flowriter_layer.cpp:53-104, imgwriter/floatwriter/
pfmwriter_layer.cpp; WriterParameter caffe.proto:656-663): each iteration,
dump a blob to ``{folder}/{prefix}{iter:07d}({n:03d}){suffix}.{ext}``; the
(n) part appears when the batch has more than one item; folders are created
on first use. The files are the JAX package's, byte for byte.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from flownet2_tpu_torch.core.flow_io import write_flo, write_pfm, write_ppm


@dataclass
class Writer:
    """Filename pattern and dispatch on kind."""

    folder: str
    kind: str = "flo"  # flo | img | float | pfm
    prefix: str = ""
    suffix: str = ""
    scale: float = 1.0
    normalize: bool = False

    def __post_init__(self):
        os.makedirs(self.folder, exist_ok=True)

    def _path(self, iteration: int, n: Optional[int], ext: str) -> str:
        mid = f"{iteration:07d}"
        if n is not None:
            mid += f"({n:03d})"
        return os.path.join(self.folder, f"{self.prefix}{mid}{self.suffix}.{ext}")

    def __call__(self, blob: np.ndarray, iteration: int) -> list[str]:
        """blob: (N, H, W, C) host array; returns the written paths."""
        blob = np.asarray(blob)
        if blob.ndim == 3:
            blob = blob[None]
        n_items = blob.shape[0]
        paths = []
        for i in range(n_items):
            tag = i if n_items > 1 else None
            item = blob[i]
            if self.kind == "flo":
                p = self._path(iteration, tag, "flo")
                write_flo(p, item[..., :2] * self.scale)
            elif self.kind == "img":
                p = self._path(iteration, tag, "ppm")
                x = item * self.scale
                if self.normalize:
                    lo, hi = x.min(), x.max()
                    x = (x - lo) / max(hi - lo, 1e-12) * 255.0
                write_ppm(p, np.clip(x, 0, 255).astype(np.uint8))
            elif self.kind == "pfm":
                p = self._path(iteration, tag, "pfm")
                write_pfm(p, item * self.scale)
            elif self.kind == "float":
                p = self._path(iteration, tag, "float3")
                _write_float_blob(p, item * self.scale)
            else:
                raise ValueError(f"unknown writer kind {self.kind!r}")
            paths.append(p)
        return paths


def _write_float_blob(path: str, arr: np.ndarray) -> None:
    """The reference's raw float-blob file: 'float\\n' magic, dim count,
    dims, then float32 data (util/output.cpp writeFloatFile convention)."""
    arr = np.asarray(arr, np.float32)
    with open(path, "wb") as f:
        f.write(b"float\n")
        dims = arr.shape
        f.write(struct.pack("<i", len(dims)))
        for d in dims:
            f.write(struct.pack("<i", d))
        arr.astype("<f4").tofile(f)


def read_float_blob(path: str) -> np.ndarray:
    """Inverse of :func:`_write_float_blob` (the FloatReader layer's input,
    floatreader_layer.cpp:41-52)."""
    with open(path, "rb") as f:
        magic = f.readline()
        if magic != b"float\n":
            raise ValueError(f"{path}: bad float-blob magic {magic!r}")
        (ndim,) = struct.unpack("<i", f.read(4))
        dims = struct.unpack(f"<{ndim}i", f.read(4 * ndim))
        data = np.fromfile(f, "<f4", count=int(np.prod(dims)))
    return data.reshape(dims)
