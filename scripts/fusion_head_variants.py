#!/usr/bin/env python3
"""Where K4's time goes: build variants of the fused-head kernels with one
part taken out, and time each beside the kernels as they are.

Each variant is a copy of ``flownet2_tpu_torch/csrc`` with text
substitutions (one stage's products skipped, the loads of concat1 and c0
skipped, the bfloat16 route's transposition skipped), built into its own
library under ``build/fusion_head_variants/``; the script times the
library's ``fn2_fusion_head`` with CUDA events (median of 10 calls after 3)
at Sintel b4 on seeded inputs, and prints each variant's registers and
spills from ``-Xptxas -v``. A variant computes a wrong head, so only the
kernels as they are (``full``) are checked against the plain version. The
time a part takes is, roughly, ``full`` less the variant without it; parts
overlap, so the differences need not add up.

    python3 scripts/fusion_head_variants.py            # on the card, from the repository root

TF32 is off, as in chip_smoke.py. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flownet2_tpu_torch import _build  # noqa: E402
from flownet2_tpu_torch.checkpoint import init_params, load_into  # noqa: E402
from flownet2_tpu_torch.models import FlowNet2  # noqa: E402
from flownet2_tpu_torch.ops.fusion_head import fusion_head_plain, head_weights, pack_fusion_head_weights  # noqa: E402

TC, F32 = "fusion_head_tc.cu", "fusion_head.cu"
SOURCES = (F32, TC, "status.cu")
_SKIP_F32 = "ci < nc; ++ci) {\n             const float* xc = "
# name -> (dtype, [(file, text, replacement)])
VARIANTS = {
    "full f32": ("float32", []),
    "full bf16": ("bfloat16", []),
    "f32 without inter_conv1's FMAs": ("float32", [(F32, _SKIP_F32 + "st + CK_I1", "ci < 0; ++ci) {\n"
                                                   "             const float* xc = st + CK_I1")]),
    "f32 without deconv0's FMAs": ("float32", [(F32, _SKIP_F32 + "st + CK_DC", "ci < 0; ++ci) {\n"
                                               "             const float* xc = st + CK_DC")]),
    "f32 without inter_conv0's FMAs": ("float32", [(F32, _SKIP_F32 + "xsrc", "ci < 0; ++ci) {\n"
                                                   "             const float* xc = xsrc")]),
    "bf16 without inter_conv1's products": ("bfloat16", [(TC, "mma_chunk<NMT, 4, 3, 3>(acc,",
                                                          "if (0) mma_chunk<NMT, 4, 3, 3>(acc,")]),
    "bf16 without deconv0's products": ("bfloat16", [(TC, "mma_chunk<NMT, 2, 2, 2>(acc,",
                                                      "if (0) mma_chunk<NMT, 2, 2, 2>(acc,")]),
    "bf16 without inter_conv0's products": ("bfloat16", [(TC, "mma_chunk<NMT, 2, 3, 3>(acc,",
                                                          "if (0) mma_chunk<NMT, 2, 3, 3>(acc,")]),
    "bf16 without any mma": ("bfloat16", [(TC, "mma_bf16(acc[mt][j], a,", "if (0) mma_bf16(acc[mt][j], a,")]),
    "bf16 without the loads of concat1 and c0": ("bfloat16", [(
        TC, "cp_async<16>(raw + 4 * i, valid ? img + ch * hw + static_cast<long long>(gy) * w + gx : img, valid);",
        "cp_async<16>(raw + 4 * i, img, false);")]),
    "bf16 without the transposition": ("bfloat16", [(TC, "i < 2 * PAIRS; i += kThreads", "i < 0; i += kThreads")]),
}


def build_variant(name: str, kernel: str, subs) -> tuple[ctypes.CDLL, str]:
    """The variant's library and the registers and spills of its kernel
    whose name contains ``kernel``."""
    out = os.path.join(ROOT, "build", "fusion_head_variants", name.replace(" ", "_").replace("'", ""))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for fname, text, repl in subs:
        path = os.path.join(out, fname)
        src = open(path).read()
        if src.count(text) < 1:
            raise RuntimeError(f"{name}: {text!r} is not in {fname}")
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
    lib.fn2_fusion_head.argtypes = list(_build._SIGNATURES["fn2_fusion_head"])
    lib.fn2_fusion_head.restype = ctypes.c_int
    res, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif fn and kernel in fn and ("registers" in line or "spill" in line):
            res.append(line.split("info    :")[-1].strip())
    return lib, "; ".join(res)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fusion_head_variants: torch.cuda.is_available() is false; this needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"K4 variants at Sintel b4, {smi}")
    with torch.device("meta"):
        net = FlowNet2()
    fusion = load_into(net, init_params("flownet2", seed=0)).fusion.to(dev)
    g = torch.Generator().manual_seed(0)
    n, h, w = 4, 448, 1024
    cat32 = torch.randn(n, 162, h // 2, w // 2, generator=g).to(dev)
    c032 = torch.randn(n, 64, h, w, generator=g).to(dev)
    for name, (dtname, subs) in VARIANTS.items():
        dtype = getattr(torch, dtname)
        lib, res = build_variant(name, "fusion_head_tc" if dtype == torch.bfloat16 else "fusion_head_f32", subs)
        weights = tuple(t.detach().to(dtype) for t in head_weights(fusion))
        packed = pack_fusion_head_weights(*weights)
        cat1, c0 = cat32.to(dtype), c032.to(dtype)
        f0 = torch.empty(n, 2, h, w, device=dev, dtype=dtype)
        f1 = torch.empty(n, 2, h // 2, w // 2, device=dev, dtype=dtype)

        def run():
            status = lib.fn2_fusion_head(cat1.data_ptr(), c0.data_ptr(), *(t.data_ptr() for t in packed),
                                         f0.data_ptr(), f1.data_ptr(), n, h // 2, w // 2, _build.DTYPE_CODES[dtype],
                                         torch.cuda.current_stream().cuda_stream)
            _build.check_status(status, name)

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        line = f"{name}: {statistics.median(times):.4f} ms ({res})"
        if not subs:
            with torch.no_grad():
                ref = fusion_head_plain(cat1, c0, *weights)
            err = max(((x.float() - r.float()).abs().max() / r.float().abs().max()).item()
                      for x, r in zip((f0, f1), ref))
            line += f"; max abs err / max |plain| {err:.3g}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
