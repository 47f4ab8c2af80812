#!/usr/bin/env python3
"""Where the 1-D correlation kernels' time goes: build variants of
``csrc/correlation1d.cu`` and ``csrc/correlation1d_bwd.cu`` with one part
taken out or one constant changed, and time each beside the kernels as
they are.

Each variant is a copy of ``flownet2_tpu_torch/csrc`` with text
substitutions, built into its own library under ``build/corr1d_variants/``;
the script times the library's ``fn2_correlation_1d`` or
``fn2_correlation_1d_backward`` (both gradients) with CUDA events (median
of 20 calls after 3) at DispNetC's FlyingThings3D features 4x128x144x240
(md 40, single_direction -1, stride2 1) on seeded inputs, and prints each
variant's registers and spills from ``-Xptxas -v``. A variant that takes a
part out computes a wrong result, so only the others are checked against
the plain version. The time a part takes is, roughly, ``full`` less the
variant without it; parts overlap, so the differences need not add up.

    python3 scripts/corr1d_variants.py [--dtypes float32 bfloat16] [--only NAME ...]

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CORR1D, CORR1D_SHAPE  # noqa: E402
from flownet2_tpu_torch import _build  # noqa: E402
from flownet2_tpu_torch.ops.correlation import correlation_1d_backward_plain, correlation_1d_plain  # noqa: E402

FWD, BWD = "correlation1d.cu", "correlation1d_bwd.cu"
SOURCES = (FWD, BWD, "status.cu")
_NO_STORES = (FWD, "      if (active && x < w) {", "      if (false) {")  # the FMAs go with them
_NO_COPIES = "  auto issue = [&](int t) {\n", "  auto issue = [&](int t) {\n    if (t >= 0) return;\n"
# name -> (kernel, [(file, text, replacement)], whether the result stays right)
VARIANTS = {
    "fwd full": ("fwd", [], True),
    "fwd without the FMAs": ("fwd", [(FWD, "    if (active) {\n      const int nch", "    if (false) {\n"
                                      "      const int nch")], False),
    "fwd without the copies": ("fwd", [(FWD, *_NO_COPIES)], False),
    "fwd copies only (no FMAs, no stores)": ("fwd", [_NO_STORES], False),
    "fwd 2 stages": ("fwd", [(FWD, "kStages = 4;", "kStages = 2;")], True),
    "fwd 6 stages": ("fwd", [(FWD, "kStages = 4;", "kStages = 6;")], True),
    "fwd 512 threads at most (one block a 240-wide row)": ("fwd", [(FWD, "kMaxThreads = 256;",
                                                                     "kMaxThreads = 512;")], True),
    "fwd channel loop unrolled 2 deep": ("fwd", [(FWD, "#pragma unroll 4\n      for (int ch = 0;",
                                                  "#pragma unroll 2\n      for (int ch = 0;")], True),
    "fwd 16 displacements a thread": ("fwd", [(FWD, "constexpr int kJT = 8;", "constexpr int kJT = 16;")], True),
    "bwd full": ("bwd", [], True),
    "bwd without the FMAs": ("bwd", [(BWD, "    if (!active || c0 >= c) continue;",
                                      "    if (true) continue;")], False),
    "bwd without the copies": ("bwd", [(BWD, *_NO_COPIES)], False),
    "bwd without the stores": ("bwd", [(BWD, "    if (x < w) {\n      T* ob", "    if (false) {\n      T* ob")],
                               False),
    "bwd 3 stages (32-channel chunks in float32)": ("bwd", [(BWD, "kStages = 2;", "kStages = 3;")], True),
    "bwd 4 channels a thread": ("bwd", [(BWD, "constexpr int kCT = 8;", "constexpr int kCT = 4;")], True),
    "bwd displacement loop not unrolled": ("bwd", [(BWD, "#pragma unroll 2\n      for (int og = 0;",
                                                    "#pragma unroll 1\n      for (int og = 0;")], True),
}


def build_variant(name: str, subs) -> tuple[ctypes.CDLL, str]:
    """The variant's library and the registers and spills of its kernels."""
    out = os.path.join(ROOT, "build", "corr1d_variants", name.replace(" ", "_"))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for fname, text, repl in subs:
        path = os.path.join(out, fname)
        src = open(path).read()
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: {text!r} is not once in {fname}")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    nvcc = _build.cuda_tool("nvcc")
    objs = [os.path.join(out, s + ".o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, os.path.join(out, s)], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for s, o in zip(SOURCES, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    lib_path = os.path.join(out, "lib.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_path, *objs], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for fn in ("fn2_correlation_1d", "fn2_correlation_1d_backward"):
        getattr(lib, fn).argtypes = list(_build._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    res, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif fn and "Li1E" in fn and ("registers" in line or "spill" in line):  # the stride2 1 kernels
            res.append(line.split("info    :")[-1].strip())
    return lib, "; ".join(dict.fromkeys(res))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
    p.add_argument("--only", nargs="+", default=None, help="variant names to run (default: all)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("corr1d_variants: torch.cuda.is_available() is false; this needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"1-D correlation variants at {CORR1D_SHAPE}, md 40, single_direction -1, stride2 1; {smi}")
    n, c, h, w = CORR1D_SHAPE
    g = torch.Generator().manual_seed(0)
    f1_32, f2_32 = (torch.randn(CORR1D_SHAPE, generator=g) for _ in range(2))
    g_32 = torch.randn((n, 41, h, w), generator=g)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (kernel, subs, right) in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        lib, res = build_variant(name, subs)
        for dtname in args.dtypes:
            dtype = getattr(torch, dtname)
            f1, f2, gg = (t.to(dev, dtype) for t in (f1_32, f2_32, g_32))
            code = _build.DTYPE_CODES[dtype]
            out = torch.empty((n, 41, h, w), device=dev, dtype=dtype)
            df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
            if kernel == "fwd":
                def run():
                    _build.check_status(lib.fn2_correlation_1d(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h,
                                                               w, 40, 1, -1, code, stream), name)
            else:
                def run():
                    _build.check_status(lib.fn2_correlation_1d_backward(
                        f1.data_ptr(), f2.data_ptr(), gg.data_ptr(), df1.data_ptr(), df2.data_ptr(), n, c, h, w, 40,
                        1, -1, code, stream), name)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            line = f"{name} {dtname}: {statistics.median(times):.4f} ms ({res})"
            if right:
                if kernel == "fwd":
                    got, ref = (out,), (correlation_1d_plain(f1, f2, **CORR1D),)
                else:
                    got, ref = (df1, df2), correlation_1d_backward_plain(f1, f2, gg, **CORR1D)
                err = max(((x.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for x, r in zip(got, ref))
                line += f"; max abs err / max |plain| {err:.3g}"
            print(line, flush=True)
            del f1, f2, gg, out, df1, df2
    return 0


if __name__ == "__main__":
    sys.exit(main())
