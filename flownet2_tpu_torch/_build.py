"""Build and load the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, on first use, into
``build/flownet2_tpu_torch/`` at the repository root; Python loads it with
``ctypes``. No PyTorch header is included, so a build takes seconds.
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "flownet2_tpu_torch"
SOURCES = (
    "warp.cu", "warp_bwd.cu", "correlation.cu", "correlation_bwd.cu", "correlation1d.cu", "correlation1d_bwd.cu",
    "head_conv.cu", "head_conv_tc.cu", "fusion_head.cu", "fusion_head_tc.cu", "status.cu",
)
HEADERS = ("common.cuh", "corr1d.cuh", "warp.cuh", "mma.cuh", "fusion_head.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Must match DtypeCode in csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # image, flow, out, n, c, h, w, image_dtype, flow_dtype, fill, stream
    "fn2_flow_warp": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # image, flow, grad, grad_image (f32 or null), grad_flow (or null), n, c, h, w,
    # image_dtype, flow_dtype, stream
    "fn2_flow_warp_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # f1, f2, out, n, h, w, c, max_displacement, stride2, dtype, stream
    "fn2_correlation": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # f1, f2, grad, df1 (or null), df2 (or null), n, h, w, c, max_displacement,
    # stride2, dtype, stream
    "fn2_correlation_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # f1, f2, out, n, c, h, w, max_displacement, stride2, single_direction, dtype, stream
    "fn2_correlation_1d": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # f1, f2, grad, df1 (or null), df2 (or null), n, c, h, w, max_displacement, stride2,
    # single_direction, dtype, stream
    "fn2_correlation_1d_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, weight (packed by ops/head_conv.pack_head_weight_f32 / pack_head_weight), bias, out, n, cin,
    # h, w, cout, k, stride, leaky, dtype, stream
    "fn2_head_conv": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, weight (packed), bias, out, n, cin, h, w, cout, leaky, dtype, stream
    "fn2_head_deconv": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # concat1, c0, then weight (packed by ops/fusion_head.pack_fusion_head_weights) and bias of
    # inter_conv1, predict_flow1, deconv0, upsample_flow1to0, inter_conv0, predict_flow0, flow0,
    # flow1, n, h2, w2, dtype, stream
    "fn2_fusion_head": (_P,) * 16 + (_I, _I, _I, _I, _P),
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's output, including -Xptxas -v's registers and spills


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    candidates = [
        os.path.join(os.environ["CUDA_HOME"], "bin", name) if "CUDA_HOME" in os.environ else None,
        shutil.which(name),
        f"/usr/local/cuda/bin/{name}",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@cache
def build() -> BuildInfo:
    """Compile the kernels unless a library built from the same sources exists."""
    digest = _digest()
    lib = BUILD_DIR / f"libflownet2_kernels_{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # write under private names and rename, so concurrent builds never
    # load a half-written library
    tag = f"{os.getpid()}.tmp"
    tmp = lib.with_name(f"{lib.name}.{tag}")
    # nvcc tells inputs by their suffix: the objects must end in .o
    objs = [BUILD_DIR / f"{Path(s).stem}_{digest}.{tag}.o" for s in SOURCES]
    nvcc = cuda_tool("nvcc")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log)


@cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fn2_error_string.argtypes = [ctypes.c_int]
    lib.fn2_error_string.restype = ctypes.c_char_p
    return lib


def hmma_counts(patterns: tuple[str, ...]) -> dict[str, int]:
    """Tensor-core (HMMA) instructions per kernel of the built library whose
    mangled name contains one of ``patterns``, from ``cuobjdump -sass``."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(build().path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if any(p in fn for p in patterns):
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def check_status(status: int, kernel: str) -> None:
    """Raise if a kernel entry point reported a launch error."""
    if status != 0:
        text = library().fn2_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({text})")
