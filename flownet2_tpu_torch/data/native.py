"""ctypes bindings for the native host data-path library
(flownet2_tpu/data/native.py): ``native/flowdata.cc``, the port's own copy
of the C++ decoder, with the same C ABI, entry points and ``ValueError``
messages.

The library is built with ``g++ -O3`` on first use into
``build/flownet2_tpu_torch/`` at the repository root, under a name that
carries a digest of the source and flags, so an edited source is rebuilt
and a stale library is never loaded. A build takes a file lock and writes
under a private name that is renamed into place, so processes that start
at once build it once and never load a half-written file. There is no
numpy fallback: a failed build raises with the compiler's output. The numpy
versions (``core/codec.py``, ``core/flow_io.py``,
``data/records.py::decode_body``) are the plain versions it is tested
against.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "flowdata.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "flownet2_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}  # by build directory


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library built from the current source and flags lives, in
    ``build_dir`` (default :data:`BUILD_DIR`)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libflowdata_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``flowdata.cc`` unless a library built from the same source
    and flags exists; returns its path. Raises ``RuntimeError`` with the
    compiler's output if ``g++`` fails or is missing."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if lib.exists():  # built by the process that held the lock
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {SOURCE.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def get_lib(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library, built first if needed (once a process for each
    ``build_dir``)."""
    key = Path(build_dir or BUILD_DIR)
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            if key not in _libs:
                _libs[key] = _bind(ctypes.CDLL(str(build(key))))
            lib = _libs[key]
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with every entry point's argument and result types declared."""
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    signatures = {
        "fd_decode_flow_i16": ([i16p, f32p, i64], None),
        "fd_encode_flow_i16": ([f32p, i16p, i64], None),
        "fd_unpack_bits": ([u8p, f32p, i64], None),
        "fd_decode_pnm": ([u8p, i64, u8p, i64, i32p, i32p, i32p], ctypes.c_int),
        "fd_read_flo": ([u8p, i64, f32p, i64, i32p, i32p], ctypes.c_int),
        "fd_decode_record": ([u8p, i64, f32p, f32p, f32p, f32p, i32p, i32p, i32p, i32p], ctypes.c_int),
        "fd_version": ([], ctypes.c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_flow_i16(data: np.ndarray) -> np.ndarray:
    """int16 fixed-point flow -> float32 (``core.codec.decode_flow_int16``)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.int16)
    out = np.empty(data.shape, np.float32)
    lib.fd_decode_flow_i16(_as_ptr(data, ctypes.c_int16), _as_ptr(out, ctypes.c_float), data.size)
    return out


def encode_flow_i16(flow: np.ndarray) -> np.ndarray:
    """float32 flow -> int16 fixed point (``core.codec.encode_flow_int16``)."""
    lib = get_lib()
    flow = np.ascontiguousarray(flow, np.float32)
    out = np.empty(flow.shape, np.int16)
    lib.fd_encode_flow_i16(_as_ptr(flow, ctypes.c_float), _as_ptr(out, ctypes.c_int16), flow.size)
    return out


def decode_pnm(buf: bytes) -> np.ndarray:
    """A binary PPM (P6) / PGM (P5) file's bytes -> uint8 (H, W, 3 or 1)."""
    lib = get_lib()
    raw = np.frombuffer(buf, np.uint8)
    w, h, ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fd_decode_pnm(_as_ptr(raw, ctypes.c_uint8), raw.size, None, 0,
                           ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"fd_decode_pnm header failed: {rc}")
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    rc = lib.fd_decode_pnm(_as_ptr(raw, ctypes.c_uint8), raw.size, _as_ptr(out, ctypes.c_uint8), out.size,
                           ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"fd_decode_pnm payload failed: {rc}")
    return out


def read_flo(buf: bytes) -> np.ndarray:
    """A ``.flo`` file's bytes -> float32 (H, W, 2)."""
    lib = get_lib()
    raw = np.frombuffer(buf, np.uint8)
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fd_read_flo(_as_ptr(raw, ctypes.c_uint8), raw.size, None, 0, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"fd_read_flo header failed: {rc}")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.fd_read_flo(_as_ptr(raw, ctypes.c_uint8), raw.size, _as_ptr(out, ctypes.c_float), out.size,
                         ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"fd_read_flo payload failed: {rc}")
    return out


def decode_record(body: bytes) -> dict:
    """One ``.flowrec`` body -> dict of float32 HWC arrays: img0, img1, flow
    (NaN where invalid) and, where the record has it, occ (H, W, 1)."""
    lib = get_lib()
    raw = np.frombuffer(body, np.uint8)
    w, h, has_occ, flow_ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    sizes = (ctypes.byref(w), ctypes.byref(h), ctypes.byref(has_occ), ctypes.byref(flow_ch))
    rc = lib.fd_decode_record(_as_ptr(raw, ctypes.c_uint8), raw.size, None, None, None, None, *sizes)
    if rc != 0:
        raise ValueError(f"fd_decode_record header failed: {rc}")
    H, W = h.value, w.value
    img0 = np.empty((H, W, 3), np.float32)
    img1 = np.empty((H, W, 3), np.float32)
    flow = np.empty((H, W, flow_ch.value), np.float32)
    occ = np.empty((H, W, 1), np.float32) if has_occ.value else None
    rc = lib.fd_decode_record(
        _as_ptr(raw, ctypes.c_uint8), raw.size, _as_ptr(img0, ctypes.c_float), _as_ptr(img1, ctypes.c_float),
        _as_ptr(flow, ctypes.c_float), _as_ptr(occ, ctypes.c_float) if occ is not None else None, *sizes)
    if rc != 0:
        raise ValueError(f"fd_decode_record payload failed: {rc}")
    out = {"img0": img0, "img1": img1, "flow": flow}
    if occ is not None:
        out["occ"] = occ
    return out
