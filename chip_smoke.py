#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Builds the hand-written CUDA kernels from ``flownet2_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card at the shapes FlowNet2
gives it (warp and correlation, forward and backward, at 448x320 batch 8,
the warp forward and its d_flow also at Sintel b4's images and the
correlation forward and backward at Sintel b4's features, the warp beside
the nearest library call, grid_sample; the head convs, K3, at Sintel size
1024x448 batch 4; the fused fusion-net decoder head, K4, at Sintel b4 and
448x320 b8 in both types, beside the unfused route it replaces; the 1-D
(stereo) correlation forward and backward at DispNetC's FlyingThings3D
features 4x128x144x240 and KITTI's 1x128x96x320, every single_direction and
stride2 1 and 2, on NCHW maps, and on bfloat16 maps at an odd storage
offset; the 2-D and 1-D correlations in the configurations no kernel takes,
card against CPU), then drives the port's paths with seeded random weights:

- inference at 448x320 b8: FlowNet2 through ``FlowRunner`` (float32 and
  bfloat16) and the ``run_flownet`` CLI, checked against the same port on
  the CPU; the head kernels launch no time there;
- inference at Sintel size, 1024x436 frames b4: FlowNet2 through
  ``FlowRunner`` (float32 and bfloat16, with and without the fused head),
  its launches of every kernel, the card against the CPU and the fused head
  against the unfused one, and the ``run_flownet_many`` CLI over jobs of two
  resolutions;
- DispNetC: ``FlowRunner("dispnetc")`` on FlyingThings3D-size frames
  (960x540 b4, adapted to 960x576; float32 and bfloat16), one launch of the
  1-D forward and none of the other kernels, the card against the CPU; the
  ``run_flownet`` CLI on a KITTI-size pair (1242x375) and
  ``run_flownet_many`` over two jobs;
- training: ``Solver`` steps at 448x320 b8 from the port's ``BatchLoader``
  over a synthetic FlyingChairs-layout directory (the FlowNetC stage in
  float32 and bfloat16, the joint FlowNet2 loss, one S1-stage step), one
  float32 loss and gradient on the card against the CPU, and the
  ``cli.train`` CLI with a resume; then DispNetC ``Solver`` steps at the
  768x384 b4 FlyingThings3D crop on synthetic left/right/disparity batches
  (one 1-D forward and one backward a step), one step card against CPU;
- Caffe weights: FlowNet2's seeded weights written by the port's exporter
  as a merged ``.caffemodel`` and ``.caffemodel.h5`` and as an ``.npz``,
  each through the ``run_flownet`` CLI at FlyingChairs' 512x384 (the three
  ``.flo`` files equal), and a standalone FlowNetC ``.caffemodel`` through
  ``FlowRunner`` at 448x320 b8 against its ``.npz``;
- training from packed records through ``cli.train``'s loader path
  (``BatchLoader`` -> ``DevicePrefetcher`` -> ``Solver.solve``): 16
  synthetic FlyingChairs pairs packed by ``cli.convert_dataset``,
  ``cli.train`` of FlowNetC on them augmented to 448x320 b8 and of DispNetC
  on a disparity ``.flowrec`` of FlyingThings3D-size pairs (in this
  process, so their launches are counted), a transport batch's loss
  against its float form's, the prefetched batches and the parameters
  after 3 steps against the direct feed, ms a step on a card-resident
  batch, fed directly from ``BatchLoader`` and fed through the prefetcher,
  in turns, and the native record decoder against numpy, with µs a
  record of each;
- training augmentation, the paper's recipe: 512x384 FlyingChairs-layout
  pairs augmented to 448x320 b8 on the card against the CPU (the affine
  sample on K1, 2 launches a step, no K2), the bfloat16 sample of the
  JAX package's accelerator route on K1 against the CPU's, the noise on
  the card, the augmentation, K1 at its canvas beside ``F.affine_grid`` +
  ``F.grid_sample`` and the augmented FlowNetC step (f32, bf16) timed
  beside the unaugmented one, and ``cli.train`` augmented from a transport
  ``.flowrec`` (``--recompute-mean``, ``--write-augmented``) and with the
  ``flownet2-sd-sdhom`` loss at its first episode; the black, eigen and
  shadow transforms on the card against the CPU;
- the scoring, timing and convergence tools: ``cli.train`` of FlowNetC on
  a synthetic split at 320x448 b8 and the held-out EPE before and after by
  ``cli.test`` (trained below 0.6 of initial), ``cli.test`` of FlowNet2,
  ``tools.overfit`` (the 1/4-resolution EPE below half its start) and
  ``tools.overfit_cascade`` (its .npz through ``cli.test``), ``cli.time_cmd``
  at 448x320 b8 and 1024x448 b4 bf16 with their per-stage tables and with
  ``--backward`` (FlowNet2's joint loss, DispNetC), ``eval_parity``
  (bfloat16 against float32 .flo files), ``device_query`` and
  ``tools.diag.bf16_parity`` on the cascade's weights, each kernel's
  launches counted;
- data-parallel training, at FlowNetC 448x320, global batch 8, float32,
  Adam, augmented from 512x384 sources: a Solver in a world-1 NCCL group
  against the plain Solver (parameters equal, the same launches a step),
  2 ranks over gloo sharing the card (4 pairs each) against one process
  on the 8 (noise 0; FlowNetC and the flownet2-s1 stage loss), the flat
  gradient all-reduce's time, and ``cli.train --gpu all`` on the one card
  with ``--gpu 0,1`` refused;
- the device sample cache and K-step training, on FlowNetS at 448x320 b8
  augmented from 512x384 transport samples of a synthetic .flowrec:
  ``Solver.solve_cached`` at K = 4 against the same batches through
  ``Solver.step`` (parameters equal; 2 K1 launches a step), the refresh
  hazard (id-filled samples swapped unthrottled while the card lags the
  host by chunks, under sync debug mode "error": no torn or stale sample),
  and ms a step resident, fed from ``BatchLoader`` through the prefetcher
  and directly, and from the cache at K = 1 and K = 32, with the
  profiler's idle shares;

and times the nets, the train steps and each kernel with CUDA events.

    python3 chip_smoke.py          # from the repository root, one card

[build] also counts the tensor-core (HMMA) instructions in the head-conv
kernels' and K4's bfloat16 kernel's SASS and fails at 0 in either. Every phase raises on failure. Standard
output ends with two JSON lines:
the kernels (name, route, source, the TPU kernel it replaces, launches in
its path's run, max abs error against the plain version, ms beside the
plain version's ms, the bound the card's peaks set for the same work and
which peak sets it, and the time of one PyTorch library call that computes
the same function, where there is one), then {"ok": true, "device": {...}}.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, H, W = 8, 320, 448
SEED = 0
CORR = dict(max_displacement=20, kernel_size=1, stride1=1, stride2=2, pad=20)
CORR_SHAPE = (N, 256, H // 8, W // 8)  # FlowNetC's conv3 features at 448x320
SINTEL_N, SINTEL_FRAME = 4, (436, 1024)  # Sintel frames; FlowRunner adapts them to 448x1024
SINTEL_H, SINTEL_W = 448, 1024
CORR_SINTEL_SHAPE = (SINTEL_N, 256, SINTEL_H // 8, SINTEL_W // 8)
# DispNetC: FlyingThings3D frames (960x540, adapted to 960x576) b4, KITTI
# 2015 (1242x375, adapted to 1280x384), the FlyingThings3D training crop
# 768x384 b4; the 1-D correlation runs on the conv2 features (stride 4)
DISP_N, DISP_FRAME, DISP_H, DISP_W = 4, (540, 960), 576, 960
KITTI_FRAME = (375, 1242)
DISP_TRAIN_N, DISP_TRAIN_H, DISP_TRAIN_W = 4, 384, 768
CORR1D = dict(max_displacement=40, kernel_size=1, stride1=1, stride2=1, pad=40, single_direction=-1)
CORR1D_SHAPE = (DISP_N, 128, DISP_H // 4, DISP_W // 4)  # 4x128x144x240
CORR1D_KITTI_SHAPE = (1, 128, 384 // 4, 1280 // 4)  # 1x128x96x320, KITTI's widest row
CHAIRS_FRAME = (384, 512)  # FlyingChairs' frames, which [weights] and [records] read
# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, dense bfloat16 on the tensor cores, and device memory
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, warmup: int = 3, runs: int = 9) -> float:
    """Median over ``runs`` of one call's device time, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def interleaved_ms(fns, rounds: int = 25, warmup: int = 3) -> list[list[float]]:
    """The device time of single calls of each of ``fns`` by CUDA events, in
    turns: ``rounds`` rounds call each once, in order on even rounds and in
    reverse on odd ones, so a drift of the clocks or of the host's load falls
    on all alike. One list of times per function."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(rounds):
        for i in range(len(fns)) if r % 2 == 0 else reversed(range(len(fns))):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return times


def quartiles(xs) -> str:
    """``median [q1, q3]`` of ``xs``, in ms."""
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"{q2:.3f} [{q1:.3f}, {q3:.3f}]"


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the peak for their type (float32 unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    print("[device] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi)
    return name, smi


def phase_build() -> None:
    from flownet2_tpu_torch import _build

    info = _build.build()
    _build.library()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {info.seconds:.1f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    counts = head_hmma_counts()
    print(f"[build] cuobjdump -sass: {sum(counts.values())} HMMA instructions in the head-conv and fusion-head "
          f"kernels ({sum(c > 0 for c in counts.values())} of {len(counts)} kernels use the tensor cores)")
    check(sum(c for k, c in counts.items() if "head_conv" in k or "head_deconv" in k) > 0,
          "no HMMA instruction in the head-conv kernels' SASS")
    fused = {k: c for k, c in counts.items() if "fusion_head_tc" in k}
    print(f"[build]   fusion_head (K4) bf16: {sum(fused.values())} HMMA instructions")
    check(len(fused) == 1 and sum(fused.values()) > 0, "no HMMA instruction in the K4 bf16 kernel's SASS")


def head_hmma_counts() -> dict:
    """Tensor-core (HMMA) instructions per head kernel (K3, both routes, and
    K4, both routes) in the built library's SASS."""
    from flownet2_tpu_torch import _build

    return _build.hmma_counts(("head_conv", "head_deconv", "fusion_head"))


def _warp_inputs(dev: torch.device, n: int = N, h: int = H, w: int = W) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized-range images (n, 3, h, w) and flows up to +-150 px: a
    smooth field plus noise, so some targets leave the image; NaN flows in
    one row."""
    g = torch.Generator().manual_seed(SEED)
    img = torch.rand(n, 3, h, w, generator=g) * 2 - 1
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    phase = torch.rand(n, 2, 1, 1, generator=g) * 6.283
    smooth = 120 * torch.sin(torch.stack([xs / 53, ys / 41])[None] + phase)
    flow = smooth + (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * 30
    flow[:, :, 11, :7] = float("nan")
    return img.to(dev), flow.to(dev)


def abs_err_and_scale(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max |ref|), in float32."""
    return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


def corr_bound(shape, dtype: torch.dtype = torch.float32, peak: float | None = None) -> dict:
    """The correlation forward's bound at features ``shape`` (N, C, H, W) in
    ``dtype``: f1 and f2 read, 441 channels written, one multiply-add per
    channel and displacement, at the type's peak (bfloat16 products are
    exact in float32 and the tensor cores sum in float32, so the function
    can run at the bfloat16 rate). ``peak=PEAK_F32_FLOPS`` gives the
    CUDA-core bound: the kernel sums on the float32 CUDA cores in both
    dtypes. No library call computes a cost volume."""
    n_, c_, h_, w_ = shape
    size, type_peak = DTYPE_PEAKS[dtype]
    return bound(size * (2 * n_ * c_ * h_ * w_ + n_ * 441 * h_ * w_), 2 * n_ * 441 * h_ * w_ * c_,
                 peak or type_peak)


def phase_kernels(dev: torch.device, card: str) -> dict:
    from flownet2_tpu_torch.ops.correlation import correlation_cuda, correlation_plain
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda, flow_warp_plain

    results = {}
    img32, flow32 = _warp_inputs(dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        img, flow = img32.to(dtype), flow32.to(dtype)
        for fill in (0.0, float("nan")):
            got = flow_warp_cuda(img, flow, fill)
            torch.cuda.synchronize()
            ref = flow_warp_plain(img, flow, fill)
            check(torch.equal(got.isnan(), ref.isnan()), f"warp {dtype} fill={fill}: NaN positions differ")
            ok = ~ref.isnan()
            err = (got.float() - ref.float())[ok].abs().max().item()
            top = ref.float()[ok].abs().max().item()
            # f32: 1e-5; bf16: one bf16 ulp of the output range
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
            print(f"[kernels] flow_warp {str(dtype)[6:]} fill={fill}: max abs err {err:.3g} (tol {tol:.3g})")
            check(err <= tol, f"warp {dtype} fill={fill}: max abs err {err} > {tol}")
            if dtype == torch.float32:
                worst = max(worst, err)
    ms = cuda_ms(lambda: flow_warp_cuda(img32, flow32))
    plain_ms = cuda_ms(lambda: flow_warp_plain(img32, flow32))
    print(f"[kernels] flow_warp f32 {N}x3x{H}x{W}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
    # No one library call fills invalid pixels: grid_sample's time, the
    # nearest call, is nearest_library_ms (phase_warp_geometries).
    results["flow_warp"] = dict(
        name="flow_warp", route="cuda", source="flownet2_tpu_torch/csrc/warp.cu",
        replaces="flownet2_tpu/ops/pallas/warp.py:158", max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **warp_bounds(N * H * W, torch.float32)[0], library_ms=None,
    )

    g = torch.Generator().manual_seed(SEED + 1)
    f1 = torch.randn(CORR_SHAPE, generator=g).to(dev)
    f2 = torch.randn(CORR_SHAPE, generator=g).to(dev)
    worst = 0.0
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        a, b = f1.to(dtype), f2.to(dtype)
        a_nhwc, b_nhwc = a.permute(0, 2, 3, 1).contiguous(), b.permute(0, 2, 3, 1).contiguous()
        got = correlation_cuda(a_nhwc, b_nhwc, max_displacement=20, stride2=2)
        torch.cuda.synchronize()
        ref = correlation_plain(a, b, **CORR)
        check(got.shape == ref.shape == (N, 441, H // 8, W // 8), f"correlation shape {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        tol = rel * ref.float().abs().max().item()
        print(f"[kernels] correlation {str(dtype)[6:]}: max abs err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"correlation {dtype}: max abs err {err} > {tol}")
        if dtype == torch.float32:
            worst = err
            ms = cuda_ms(lambda: correlation_cuda(a_nhwc, b_nhwc, max_displacement=20, stride2=2))
            plain_ms = cuda_ms(lambda: correlation_plain(a, b, **CORR))
    b = corr_bound(CORR_SHAPE)
    print(f"[kernels] correlation f32 {CORR_SHAPE} NCHW -> 441 channels: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) ({card})")
    results["correlation"] = dict(
        name="correlation", route="cuda", source="flownet2_tpu_torch/csrc/correlation.cu",
        replaces="flownet2_tpu/ops/correlation.py:434", max_abs_err=worst, ms=ms, plain_ms=plain_ms, **b,
        library_ms=None,
    )
    # the Sintel b4 feature shape: checked in both dtypes and timed beside its bound
    g = torch.Generator().manual_seed(SEED + 7)
    s1, s2 = (torch.randn(CORR_SINTEL_SHAPE, generator=g).to(dev) for _ in range(2))
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        a, b_ = s1.to(dtype), s2.to(dtype)
        a_nhwc, b_nhwc = a.permute(0, 2, 3, 1).contiguous(), b_.permute(0, 2, 3, 1).contiguous()
        got = correlation_cuda(a_nhwc, b_nhwc, max_displacement=20, stride2=2)
        torch.cuda.synchronize()
        err, top = abs_err_and_scale(got, correlation_plain(a, b_, **CORR))
        check(err <= rel * top, f"correlation Sintel {dtype}: max abs err {err} > {rel * top}")
        ms = cuda_ms(lambda: correlation_cuda(a_nhwc, b_nhwc, max_displacement=20, stride2=2))
        b = corr_bound(CORR_SINTEL_SHAPE, dtype)
        cc = corr_bound(CORR_SINTEL_SHAPE, dtype, PEAK_F32_FLOPS)
        print(f"[kernels] correlation {str(dtype)[6:]} {CORR_SINTEL_SHAPE} (Sintel b4) -> 441 channels: max abs err "
              f"{err:.3g} (tol {rel * top:.3g}); kernel {ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"CUDA-core bound {cc['bound_ms']:.4f} ms ({cc['bound_by']}) ({card})")
        del a, b_, a_nhwc, b_nhwc, got
    results.update(phase_backward_kernels(dev, card, img32, flow32, f1, f2))
    phase_warp_geometries(dev, card, results)
    return results


def phase_backward_kernels(dev, card, img32, flow32, f1, f2) -> dict:
    """K2 and the correlation's backward: through the autograd Functions
    (fill 0 and NaN for the warp) against autograd through the plain
    versions on the card at 448x320 b8, and the correlation backward's
    wrapper at Sintel b4's features; limits 1e-5 (f32) and 2e-2 (bf16) x
    max|ref|. Each timed beside its bound in both dtypes, K2 also as the
    path calls it (d_flow only)."""
    from flownet2_tpu_torch.ops.correlation import (
        correlation, correlation_backward_cuda, correlation_backward_plain,
    )
    from flownet2_tpu_torch.ops.warp import (
        flow_warp, flow_warp_backward_cuda, flow_warp_backward_plain, flow_warp_plain,
    )

    results = {}
    g32 = torch.randn(img32.shape, generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
    worst = 0.0
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        img, flow, g = img32.to(dtype), flow32.to(dtype), g32.to(dtype)
        for fill in (0.0, float("nan")):
            a, b = img.clone().requires_grad_(True), flow.clone().requires_grad_(True)
            got = torch.autograd.grad(flow_warp(a, b, fill), (a, b), g)
            torch.cuda.synchronize()
            a, b = img.clone().requires_grad_(True), flow.clone().requires_grad_(True)
            ref = torch.autograd.grad(flow_warp_plain(a, b, fill), (a, b), g)
            for what, x, y in zip(("d_image", "d_flow"), got, ref):
                err, top = abs_err_and_scale(x, y)
                check(bool(torch.isfinite(x).all()) and x.dtype == dtype, f"warp bwd {what} {dtype}: finite, dtype")
                print(f"[kernels] flow_warp_backward {str(dtype)[6:]} fill={fill} {what}: max abs err {err:.3g} "
                      f"(tol {rel * top:.3g})")
                check(err <= rel * top, f"warp bwd {dtype} fill={fill} {what}: max abs err {err} > {rel * top}")
                if dtype == torch.float32:
                    worst = max(worst, err)
            check(not got[1][:, :, 11, :7].any(), "warp bwd: NaN flows must pass gradient 0")
    ms = cuda_ms(lambda: flow_warp_backward_cuda(img32, flow32, g32))
    flow_ms = cuda_ms(lambda: flow_warp_backward_cuda(img32, flow32, g32, need_image=False))
    plain_ms = cuda_ms(lambda: flow_warp_backward_plain(img32, flow32, g32))
    # image, flow and g read, d_image and d_flow written; about 20 operations
    # per channel (4 weighted scatters, the two spatial differences). The
    # path asks for d_flow only (warp_bounds).
    px = N * H * W
    both, flow_only = bound(4 * px * (3 + 2 + 3 + 3 + 2), 20 * 3 * px), warp_bounds(px, torch.float32)[1]
    print(f"[kernels] flow_warp_backward f32 {N}x3x{H}x{W}: kernel {ms:.4f} ms, bound {both['bound_ms']:.4f} ms "
          f"({both['bound_by']}); d_flow only (as the path calls it) {flow_ms:.4f} ms, bound "
          f"{flow_only['bound_ms']:.4f} ms ({flow_only['bound_by']}); plain {plain_ms:.4f} ms ({card})")
    results["flow_warp_backward"] = dict(
        name="flow_warp_backward", route="cuda", source="flownet2_tpu_torch/csrc/warp_bwd.cu",
        replaces="flownet2_tpu/ops/pallas/warp.py:374", max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **both, library_ms=None, d_flow_only_ms=flow_ms, d_flow_only_bound_ms=flow_only["bound_ms"],
        d_flow_only_bound_by=flow_only["bound_by"],
    )

    g_corr = torch.randn((N, 441, H // 8, W // 8), generator=torch.Generator().manual_seed(SEED + 3)).to(dev)
    worst = 0.0
    for dtype, rel in REL_TOL.items():
        a, b, g = f1.to(dtype).requires_grad_(True), f2.to(dtype).requires_grad_(True), g_corr.to(dtype)
        got = torch.autograd.grad(correlation(a, b, **CORR), (a, b), g)
        torch.cuda.synchronize()
        ref = correlation_backward_plain(a.detach(), b.detach(), g, **CORR)
        for what, x, y in zip(("df1", "df2"), got, ref):
            err, top = abs_err_and_scale(x, y)
            check(x.shape == y.shape and x.dtype == dtype, f"correlation bwd {what} {dtype}: shape, dtype")
            print(f"[kernels] correlation_backward {str(dtype)[6:]} {what}: max abs err {err:.3g} "
                  f"(tol {rel * top:.3g})")
            check(err <= rel * top, f"correlation bwd {dtype} {what}: max abs err {err} > {rel * top}")
            if dtype == torch.float32:
                worst = max(worst, err)
    plain_ms = cuda_ms(lambda: correlation_backward_plain(f1, f2, g_corr, **CORR), warmup=1, runs=3)
    times = {}
    for dtype in DTYPE_PEAKS:
        a_nhwc, b_nhwc = (t.to(dtype).permute(0, 2, 3, 1).contiguous() for t in (f1, f2))
        g = g_corr.to(dtype)
        times[dtype] = cuda_ms(lambda: correlation_backward_cuda(a_nhwc, b_nhwc, g, max_displacement=20, stride2=2))
        b_, cc = corr_bwd_bound(CORR_SHAPE, dtype), corr_bwd_bound(CORR_SHAPE, dtype, PEAK_F32_FLOPS)
        print(f"[kernels] correlation_backward {str(dtype)[6:]} {CORR_SHAPE} NCHW, 441 channels, df1 and df2: "
              f"kernel {times[dtype]:.4f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}), CUDA-core bound "
              f"{cc['bound_ms']:.4f} ms ({cc['bound_by']})"
              f"{f', plain {plain_ms:.4f} ms' if dtype == torch.float32 else ''} ({card})")
        del a_nhwc, b_nhwc, g
    b16, cc16 = corr_bwd_bound(CORR_SHAPE, torch.bfloat16), corr_bwd_bound(CORR_SHAPE, torch.bfloat16, PEAK_F32_FLOPS)
    results["correlation_backward"] = dict(
        name="correlation_backward", route="cuda", source="flownet2_tpu_torch/csrc/correlation_bwd.cu",
        replaces="flownet2_tpu/ops/correlation.py:252", max_abs_err=worst, ms=times[torch.float32],
        plain_ms=plain_ms, **corr_bwd_bound(CORR_SHAPE), library_ms=None, bf16_ms=times[torch.bfloat16],
        bf16_bound_ms=b16["bound_ms"], bf16_bound_by=b16["bound_by"], bf16_cuda_core_bound_ms=cc16["bound_ms"],
    )
    # the Sintel b4 feature shape: checked in both dtypes and timed beside its bound
    gen = torch.Generator().manual_seed(SEED + 8)
    s1, s2 = (torch.randn(CORR_SINTEL_SHAPE, generator=gen).to(dev) for _ in range(2))
    n_, _, h_, w_ = CORR_SINTEL_SHAPE
    gs = torch.randn((n_, 441, h_, w_), generator=gen).to(dev)
    for dtype, rel in REL_TOL.items():
        a, b, g = s1.to(dtype), s2.to(dtype), gs.to(dtype)
        a_nhwc, b_nhwc = a.permute(0, 2, 3, 1).contiguous(), b.permute(0, 2, 3, 1).contiguous()
        got = correlation_backward_cuda(a_nhwc, b_nhwc, g, max_displacement=20, stride2=2)
        torch.cuda.synchronize()
        ref = correlation_backward_plain(a, b, g, **CORR)
        errs = []
        for what, x, y in zip(("df1", "df2"), got, ref):
            err, top = abs_err_and_scale(x, y.permute(0, 2, 3, 1))
            check(err <= rel * top, f"correlation bwd Sintel {dtype} {what}: max abs err {err} > {rel * top}")
            errs.append(f"{what} {err:.3g} (tol {rel * top:.3g})")
        del got, ref
        ms = cuda_ms(lambda: correlation_backward_cuda(a_nhwc, b_nhwc, g, max_displacement=20, stride2=2))
        b_, cc = corr_bwd_bound(CORR_SINTEL_SHAPE, dtype), corr_bwd_bound(CORR_SINTEL_SHAPE, dtype, PEAK_F32_FLOPS)
        print(f"[kernels] correlation_backward {str(dtype)[6:]} {CORR_SINTEL_SHAPE} (Sintel b4), df1 and df2: "
              f"max abs err {'; '.join(errs)}; kernel {ms:.4f} ms, bound {b_['bound_ms']:.4f} ms "
              f"({b_['bound_by']}), CUDA-core bound {cc['bound_ms']:.4f} ms ({cc['bound_by']}) ({card})")
        name = f"sintel_{str(dtype)[6:]}"
        results["correlation_backward"].update(
            {f"{name}_ms": ms, f"{name}_bound_ms": b_["bound_ms"], f"{name}_cuda_core_bound_ms": cc["bound_ms"]})
        del a, b, g, a_nhwc, b_nhwc
    torch.cuda.empty_cache()
    return results


def _sample_grid(flow: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """grid_sample's (N, H, W, 2) grid for ``flow`` (N, 2, H, W): the float32
    sample positions x + u, y + v that the warp computes, normalized for
    align_corners=True in float64, then cast to ``dtype``. A NaN flow
    becomes 1e4 px, far outside the image (grid_sample's backward indexes
    out of bounds at a NaN coordinate)."""
    h_, w_ = flow.shape[2:]
    flow = flow.nan_to_num(nan=1e4)
    ys, xs = torch.meshgrid(torch.arange(h_, dtype=torch.float32, device=flow.device),
                            torch.arange(w_, dtype=torch.float32, device=flow.device), indexing="ij")
    x2, y2 = (xs + flow[:, 0].float()).double(), (ys + flow[:, 1].float()).double()
    return torch.stack((2 * x2 / (w_ - 1) - 1, 2 * y2 / (h_ - 1) - 1), dim=-1).to(dtype)


def warp_bounds(px: int, dtype: torch.dtype) -> tuple[dict, dict]:
    """K1's and K2's (d_flow only) bounds over ``px`` pixels of 3 channels,
    image and flow both in ``dtype``: K1 reads the image and the flow and
    writes the output, 3 lerps (9 operations) per channel; K2 reads the
    image, the flow and g and writes d_flow, about 10 operations per
    channel. The arithmetic is float32 in both dtypes."""
    size = DTYPE_PEAKS[dtype][0]
    return bound(size * px * (3 + 2 + 3), 9 * 3 * px), bound(size * px * (3 + 2 + 3 + 2), 10 * 3 * px)


def phase_warp_geometries(dev: torch.device, card: str, results: dict) -> None:
    """K1 and K2 (d_flow only, as the joint step calls it) at both FlowNet2
    geometries (448x320 b8, Sintel b4 4x3x448x1024) and dtypes, each timed
    beside its bound and the nearest library call: F.grid_sample (bilinear,
    border, align_corners=True) equals the warp on every valid pixel, and
    its backward with output_mask [False, True] gives d_grid alone. Neither
    fills invalid pixels (that takes a second op), so library_ms stays null
    and the time goes in nearest_library_ms. First holds grid_sample to
    flow_warp_plain on the valid pixels (float64, within 1e-4), and K1 and
    K2 at Sintel b4 to their plain versions (K1: f32 1e-5, bf16 one bf16 ulp
    of the output range, NaN positions equal; K2's d_flow: 1e-5 / 2e-2 x
    max|ref|, 0 at NaN flows). Times at 448x320 b8 f32 are the entries'
    own ms and d_flow_only_ms."""
    import torch.nn.functional as F

    from flownet2_tpu_torch.ops.warp import (
        flow_warp_backward_cuda, flow_warp_backward_plain, flow_warp_cuda, flow_warp_plain,
    )

    def library_fwd(img, grid):
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)

    def library_bwd(g, img, grid):  # interpolation 0: bilinear, padding 1: border
        return torch.ops.aten.grid_sampler_2d_backward(g, img, grid, 0, 1, True, [False, True])

    k1, k2 = results["flow_warp"], results["flow_warp_backward"]
    for geom, (n_, h_, w_) in (("", (N, H, W)), ("sintel_", (SINTEL_N, SINTEL_H, SINTEL_W))):
        img32, flow32 = _warp_inputs(dev, n_, h_, w_)
        g32 = torch.randn(img32.shape, generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
        ref = flow_warp_plain(img32, flow32, float("nan"))
        ok = ~ref.isnan()
        err = (library_fwd(img32.double(), _sample_grid(flow32, torch.float64)) - ref.double())[ok].abs().max().item()
        print(f"[kernels] grid_sample (float64) vs flow_warp_plain {n_}x3x{h_}x{w_}, valid pixels: max abs err "
              f"{err:.3g} (tol 1e-4)")
        check(err <= 1e-4, f"grid_sample vs flow_warp_plain {n_}x3x{h_}x{w_}: {err} > 1e-4")
        for dtype, rel in REL_TOL.items():
            img, flow, g = img32.to(dtype), flow32.to(dtype), g32.to(dtype)
            if geom:
                for fill in (0.0, float("nan")):
                    got = flow_warp_cuda(img, flow, fill)
                    torch.cuda.synchronize()
                    ref = flow_warp_plain(img, flow, fill)
                    check(torch.equal(got.isnan(), ref.isnan()), f"warp Sintel {dtype} fill={fill}: NaN positions")
                    err, top = abs_err_and_scale(got[~ref.isnan()], ref[~ref.isnan()])
                    tol = 1e-5 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
                    check(err <= tol, f"warp Sintel {dtype} fill={fill}: max abs err {err} > {tol}")
                _, got = flow_warp_backward_cuda(img, flow, g, need_image=False)
                torch.cuda.synchronize()
                _, ref = flow_warp_backward_plain(img, flow, g)
                err2, top2 = abs_err_and_scale(got, ref)
                check(err2 <= rel * top2 and not got[:, :, 11, :7].any(),
                      f"warp bwd Sintel {dtype} d_flow: max abs err {err2} > {rel * top2}, or NaN flows pass a gradient")
                print(f"[kernels] flow_warp Sintel {str(dtype)[6:]}: max abs err {err:.3g} (tol {tol:.3g}); backward d_flow "
                      f"only {err2:.3g} (tol {rel * top2:.3g})")
                del got, ref
            grid = _sample_grid(flow32, dtype)
            tag = f"{geom}{str(dtype)[6:].replace('float32', 'f32').replace('bfloat16', 'bf16')}"
            lib1 = cuda_ms(lambda: library_fwd(img, grid))
            lib2 = cuda_ms(lambda: library_bwd(g, img, grid))
            b1, b2 = warp_bounds(n_ * h_ * w_, dtype)
            if tag == "f32":  # 448x320 b8 f32: the entries' own times
                ms1, ms2 = k1["ms"], k2["d_flow_only_ms"]
                k1["nearest_library_ms"], k2["nearest_library_ms"] = lib1, lib2
            else:
                ms1 = cuda_ms(lambda: flow_warp_cuda(img, flow))
                ms2 = cuda_ms(lambda: flow_warp_backward_cuda(img, flow, g, need_image=False))
                k1.update({f"{tag}_ms": ms1, f"{tag}_bound_ms": b1["bound_ms"], f"{tag}_nearest_library_ms": lib1})
                k2.update({f"d_flow_only_{tag}_ms": ms2, f"d_flow_only_{tag}_bound_ms": b2["bound_ms"],
                           f"d_flow_only_{tag}_nearest_library_ms": lib2})
            print(f"[kernels] flow_warp {str(dtype)[6:]} {n_}x3x{h_}x{w_}: K1 {ms1:.4f} ms, bound {b1['bound_ms']:.4f} "
                  f"ms ({b1['bound_by']}), grid_sample {lib1:.4f} ms; K2 d_flow only {ms2:.4f} ms, bound "
                  f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}), grid_sampler_2d_backward (d_grid only) {lib2:.4f} "
                  f"ms ({card})")
            del img, flow, g, grid
        del img32, flow32, g32
        torch.cuda.empty_cache()


def corr_bwd_bound(shape, dtype: torch.dtype = torch.float32, peak: float | None = None) -> dict:
    """The correlation backward's bound at features ``shape`` (N, C, H, W) in
    ``dtype``: f1, f2 and the 441-channel g read, df1 and df2 written, two
    multiply-adds per channel and displacement, at the type's peak;
    ``peak=PEAK_F32_FLOPS`` gives the CUDA-core bound (as :func:`corr_bound`)."""
    n_, c_, h_, w_ = shape
    size, type_peak = DTYPE_PEAKS[dtype]
    return bound(size * (4 * n_ * c_ * h_ * w_ + n_ * 441 * h_ * w_), 4 * n_ * 441 * h_ * w_ * c_,
                 peak or type_peak)


def corr1d_pairs(w: int, gw: int, stride2: int, x_shift: int) -> int:
    """Column pairs (x, j) of one row whose partner column x + (j +
    x_shift) stride2 lies inside the map: the multiply-adds per channel that
    the 1-D correlation needs (the others meet the zero padding)."""
    return sum(max(0, w - abs((j + x_shift) * stride2)) for j in range(gw))


def corr1d_bound(shape, dtype: torch.dtype = torch.float32, *, backward: bool = False,
                 peak: float | None = None) -> dict:
    """The 1-D correlation's bound in DispNet's configuration (41 one-sided
    channels) at features ``shape`` (N, C, H, W) in ``dtype``: forward, f1
    and f2 read and the 41 channels written, one multiply-add per channel
    and in-map column pair; backward, f1, f2 and g read, df1 and df2
    written, two. At the type's peak, or ``peak`` (PEAK_F32_FLOPS: the
    CUDA-core bound). No library call computes a cost volume."""
    n_, c_, h_, w_ = shape
    size, type_peak = DTYPE_PEAKS[dtype]
    maps, volume = n_ * c_ * h_ * w_, n_ * 41 * h_ * w_
    macs = n_ * h_ * corr1d_pairs(w_, 41, 1, -40) * c_
    if backward:
        return bound(size * (4 * maps + volume), 4 * macs, peak or type_peak)
    return bound(size * (2 * maps + volume), 2 * macs, peak or type_peak)


def phase_corr1d_kernels(dev: torch.device, card: str) -> dict:
    """The 1-D correlation's kernels against their plain versions on the
    card, limits 1e-5 (f32) and 2e-2 (bf16) x max|ref|: DispNet's
    configuration at the FlyingThings3D features 4x128x144x240 in both
    dtypes (the forward through its wrapper, the backward through autograd),
    each timed beside its plain version and its bound; then the forward and
    both gradients at KITTI's 1x128x96x320 for every single_direction and
    stride2 1 and 2, both dtypes, DispNet's configuration timed. The JSON
    entries' plain keys are float32 at 4x128x144x240, ``*_bf16`` bfloat16
    there, ``kitti_*`` float32 at 1x128x96x320. Both kernels take the nets'
    NCHW maps as they are. Then bfloat16 maps at an odd storage offset and
    an odd width (:func:`corr1d_offset_case`) and the configurations no
    kernel takes (:func:`general_correlations`)."""
    from flownet2_tpu_torch.ops.correlation import (
        correlation_1d, correlation_1d_backward_cuda, correlation_1d_backward_plain, correlation_1d_cuda,
        correlation_1d_plain,
    )

    wrap_kw = dict(max_displacement=40, stride2=1, single_direction=-1)
    fwd = dict(name="correlation_1d", route="cuda", source="flownet2_tpu_torch/csrc/correlation1d.cu",
               replaces="flownet2_tpu/ops/correlation.py:497", library_ms=None)
    bwd = dict(name="correlation_1d_backward", route="cuda", source="flownet2_tpu_torch/csrc/correlation1d_bwd.cu",
               replaces="flownet2_tpu/ops/correlation.py:519", library_ms=None)
    gen = torch.Generator().manual_seed(SEED + 10)
    n_, _, h_, w_ = CORR1D_SHAPE
    f1, f2 = (torch.randn(CORR1D_SHAPE, generator=gen).to(dev) for _ in range(2))
    g = torch.randn((n_, 41, h_, w_), generator=gen).to(dev)
    for dtype, rel in REL_TOL.items():
        a, b, gg = f1.to(dtype), f2.to(dtype), g.to(dtype)
        got = correlation_1d_cuda(a, b, **wrap_kw)
        torch.cuda.synchronize()
        ref = correlation_1d_plain(a, b, **CORR1D)
        check(got.shape == ref.shape == (n_, 41, h_, w_) and got.dtype == dtype,
              f"correlation_1d {dtype}: shape, dtype")
        err, top = abs_err_and_scale(got, ref)
        check(err <= rel * top, f"correlation_1d {dtype}: max abs err {err} > {rel * top}")
        del got, ref
        ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        dgot = torch.autograd.grad(correlation_1d(ag, bg, **CORR1D), (ag, bg), gg)
        torch.cuda.synchronize()
        dref = correlation_1d_backward_plain(a, b, gg, **CORR1D)
        berrs, berr = [], 0.0
        for what, x, y in zip(("df1", "df2"), dgot, dref):
            e_, t_ = abs_err_and_scale(x, y)
            check(x.shape == y.shape and x.dtype == dtype, f"correlation_1d bwd {what} {dtype}: shape, dtype")
            check(e_ <= rel * t_, f"correlation_1d bwd {dtype} {what}: max abs err {e_} > {rel * t_}")
            berrs.append(f"{what} {e_:.3g} (tol {rel * t_:.3g})")
            berr = max(berr, e_)
        del dgot, dref, ag, bg
        ms = cuda_ms(lambda: correlation_1d_cuda(a, b, **wrap_kw))
        bms = cuda_ms(lambda: correlation_1d_backward_cuda(a, b, gg, **wrap_kw))
        plain_ms = cuda_ms(lambda: correlation_1d_plain(a, b, **CORR1D))
        plain_bms = cuda_ms(lambda: correlation_1d_backward_plain(a, b, gg, **CORR1D), warmup=1, runs=3)
        bf, bb = corr1d_bound(CORR1D_SHAPE, dtype), corr1d_bound(CORR1D_SHAPE, dtype, backward=True)
        ccf = corr1d_bound(CORR1D_SHAPE, dtype, peak=PEAK_F32_FLOPS)
        ccb = corr1d_bound(CORR1D_SHAPE, dtype, backward=True, peak=PEAK_F32_FLOPS)
        dt = str(dtype)[6:]
        print(f"[kernels] correlation_1d {dt} {CORR1D_SHAPE} NCHW -> 41 channels: max abs err {err:.3g} (tol "
              f"{rel * top:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bf['bound_ms']:.4f} ms "
              f"({bf['bound_by']}), CUDA-core bound {ccf['bound_ms']:.4f} ms ({ccf['bound_by']}) ({card})")
        print(f"[kernels] correlation_1d_backward {dt} {CORR1D_SHAPE}, df1 and df2: max abs err {'; '.join(berrs)}; "
              f"kernel {bms:.4f} ms, plain {plain_bms:.4f} ms, bound {bb['bound_ms']:.4f} ms ({bb['bound_by']}), "
              f"CUDA-core bound {ccb['bound_ms']:.4f} ms ({ccb['bound_by']}) ({card})")
        suffix = "" if dtype == torch.float32 else "_bf16"
        for entry, e, t, p, bd in ((fwd, err, ms, plain_ms, bf), (bwd, berr, bms, plain_bms, bb)):
            entry.update({f"max_abs_err{suffix}": e, f"ms{suffix}": t, f"plain_ms{suffix}": p,
                          f"bound_ms{suffix}": bd["bound_ms"], f"bound_by{suffix}": bd["bound_by"]})
        del a, b, gg
    del f1, f2, g

    gen = torch.Generator().manual_seed(SEED + 11)
    k1, k2 = (torch.randn(CORR1D_KITTI_SHAPE, generator=gen).to(dev) for _ in range(2))
    kn, _, kh, kw_ = CORR1D_KITTI_SHAPE
    for sd in (-1, 0, 1):
        for s2 in (1, 2):
            kw = dict(max_displacement=40, kernel_size=1, stride1=1, stride2=s2, pad=40, single_direction=sd)
            wkw = dict(max_displacement=40, stride2=s2, single_direction=sd)
            gw = 40 // s2 + 1 if sd else 2 * (40 // s2) + 1
            gk = torch.randn((kn, gw, kh, kw_), generator=gen).to(dev)
            errs = []
            for dtype, rel in REL_TOL.items():
                a, b, gg = k1.to(dtype), k2.to(dtype), gk.to(dtype)
                got = correlation_1d_cuda(a, b, **wkw)
                dgot = correlation_1d_backward_cuda(a, b, gg, **wkw)
                torch.cuda.synchronize()
                ref = correlation_1d_plain(a, b, **kw)
                dref = correlation_1d_backward_plain(a, b, gg, **kw)
                for what, x, y in (("out", got, ref), ("df1", dgot[0], dref[0]), ("df2", dgot[1], dref[1])):
                    e_, t_ = abs_err_and_scale(x, y)
                    check(x.shape == y.shape, f"correlation_1d KITTI sd={sd} stride2={s2} {what} {dtype}: shape")
                    check(e_ <= rel * t_, f"correlation_1d KITTI sd={sd} stride2={s2} {what} {dtype}: "
                                          f"max abs err {e_} > {rel * t_}")
                    errs.append(f"{str(dtype)[6:]} {what} {e_:.3g} (tol {rel * t_:.3g})")
                if (sd, s2, dtype) == (-1, 1, torch.float32):
                    kms = cuda_ms(lambda: correlation_1d_cuda(a, b, **wkw))
                    kbms = cuda_ms(lambda: correlation_1d_backward_cuda(a, b, gg, **wkw))
                    kbf = corr1d_bound(CORR1D_KITTI_SHAPE)
                    kbb = corr1d_bound(CORR1D_KITTI_SHAPE, backward=True)
                    fwd.update(kitti_ms=kms, kitti_bound_ms=kbf["bound_ms"])
                    bwd.update(kitti_ms=kbms, kitti_bound_ms=kbb["bound_ms"])
                    print(f"[kernels] correlation_1d f32 {CORR1D_KITTI_SHAPE} (KITTI): forward {kms:.4f} ms, bound "
                          f"{kbf['bound_ms']:.4f} ms ({kbf['bound_by']}); backward {kbms:.4f} ms, bound "
                          f"{kbb['bound_ms']:.4f} ms ({kbb['bound_by']}) ({card})")
                del a, b, gg, got, dgot, ref, dref
            print(f"[kernels] correlation_1d {CORR1D_KITTI_SHAPE} single_direction={sd} stride2={s2} ({gw} "
                  f"channels), forward and backward: max abs err {'; '.join(errs)}")
    del k1, k2
    corr1d_offset_case(dev)
    general_correlations(dev)
    torch.cuda.empty_cache()
    return {"correlation_1d": fwd, "correlation_1d_backward": bwd}


def corr1d_offset_case(dev: torch.device) -> None:
    """Both 1-D kernels on bfloat16 NCHW maps that start one element into
    their allocation, 241 columns wide (odd, so every other channel row
    starts on an odd element: no cp.async copy can move its first column),
    DispNet's configuration: within 2e-2 x max|ref| of the plain versions."""
    from flownet2_tpu_torch.ops.correlation import (
        correlation_1d_backward_cuda, correlation_1d_backward_plain, correlation_1d_cuda, correlation_1d_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 12)
    shape = (2, 128, 8, 241)
    numel = int(np.prod(shape))
    buf = torch.randn(2 * numel + 1, generator=gen).to(dev, torch.bfloat16)
    a, b = buf[1:1 + numel].view(shape), buf[1 + numel:].view(shape)
    gg = torch.randn((2, 41, 8, 241), generator=gen).to(dev, torch.bfloat16)
    kw = dict(max_displacement=40, stride2=1, single_direction=-1)
    got, dgot = correlation_1d_cuda(a, b, **kw), correlation_1d_backward_cuda(a, b, gg, **kw)
    torch.cuda.synchronize()
    errs = []
    for what, x, y in (("out", got, correlation_1d_plain(a, b, **CORR1D)),
                       *zip(("df1", "df2"), dgot, correlation_1d_backward_plain(a, b, gg, **CORR1D))):
        e_, t_ = abs_err_and_scale(x, y)
        check(x.shape == y.shape and e_ <= 2e-2 * t_, f"correlation_1d bf16 offset 1 {what}: max abs err {e_}")
        errs.append(f"{what} {e_:.3g} (tol {2e-2 * t_:.3g})")
    print(f"[kernels] correlation_1d bf16 {shape} at storage offset 1, forward and backward: max abs err "
          f"{'; '.join(errs)}")


# Correlation configurations no kernel takes (the kernels' is multiply, k 1,
# stride1 1, pad == md): the dispatchers run the plain versions on the card
GENERAL_CORR_CONFIGS = {
    "k3": dict(max_displacement=4, kernel_size=3, stride1=1, stride2=1, pad=5),
    "stride1 2": dict(max_displacement=4, kernel_size=1, stride1=2, stride2=2, pad=4),
    "subtract": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=1, pad=4, multiply=False),
    "pad 2 < md 4": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=2, pad=2),
}


def general_correlations(dev: torch.device) -> None:
    """``correlation`` and ``correlation_1d`` on the card in each of
    GENERAL_CORR_CONFIGS: the output and both gradients (autograd) within
    1e-5 x max|ref| of the same call on the CPU, and no kernel launched."""
    from flownet2_tpu_torch.ops.correlation import (
        correlation, correlation_1d, correlation_1d_backward_cuda, correlation_1d_cuda, correlation_backward_cuda,
        correlation_cuda,
    )

    kernels = (correlation_cuda, correlation_backward_cuda, correlation_1d_cuda, correlation_1d_backward_cuda)
    before = [k.launches for k in kernels]
    gen = torch.Generator().manual_seed(SEED + 13)
    f1, f2 = (torch.randn(2, 32, 24, 40, generator=gen) for _ in range(2))
    worst = 0.0
    for case, kw in GENERAL_CORR_CONFIGS.items():
        for port, extra in ((correlation, {}), (correlation_1d, dict(single_direction=-1))):
            results = []
            for d in (dev, torch.device("cpu")):
                a, b = f1.to(d).requires_grad_(True), f2.to(d).requires_grad_(True)
                out = port(a, b, **kw, **extra)
                grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED + 14)).to(d)
                results.append((out.detach(), *torch.autograd.grad(out, (a, b), grad)))
            torch.cuda.synchronize()
            for what, x, y in zip(("out", "df1", "df2"), *results):
                e_, t_ = abs_err_and_scale(x.cpu(), y)
                check(x.device.type == "cuda" and x.shape == y.shape and e_ <= 1e-5 * t_,
                      f"{port.__name__} {case} on the card vs the CPU, {what}: max abs err {e_} > {1e-5 * t_}")
                worst = max(worst, e_ / max(t_, 1e-30))
    check([k.launches for k in kernels] == before, "general correlation configurations launched a kernel")
    print(f"[kernels] correlation and correlation_1d, {', '.join(GENERAL_CORR_CONFIGS)} (no kernel takes "
          f"them): card vs CPU, output and both gradients, worst max abs err {worst:.3g} x max|ref| (tol 1e-5)")


# K3's geometries at Sintel b4, one per distinct layer shape of a FlowNet2
# forward: (label, input (N, Cin, H, W), weight shape, stride (0: the k4/s2
# deconv), leaky, launches per forward)
HEAD_GEOMETRIES = (
    ("7x7/s2 3->64 (FlowNetC conv1, per tower)", (SINTEL_N, 3, SINTEL_H, SINTEL_W), (64, 3, 7, 7), 2, True, 2),
    ("7x7/s2 12->64 (FlowNetS_1/_2 conv1)", (SINTEL_N, 12, SINTEL_H, SINTEL_W), (64, 12, 7, 7), 2, True, 2),
    ("3x3/s1 6->64 (FlowNetSD conv0)", (SINTEL_N, 6, SINTEL_H, SINTEL_W), (64, 6, 3, 3), 1, True, 1),
    ("3x3/s1 11->64 (fusion conv0)", (SINTEL_N, 11, SINTEL_H, SINTEL_W), (64, 11, 3, 3), 1, True, 1),
    ("3x3/s2 64->64 (FlowNetSD conv1, fusion conv1)", (SINTEL_N, 64, SINTEL_H, SINTEL_W), (64, 64, 3, 3), 2, True,
     2),
    ("3x3/s1 82->16 (fusion inter_conv0)", (SINTEL_N, 82, SINTEL_H, SINTEL_W), (16, 82, 3, 3), 1, False, 1),
    ("3x3/s1 16->2 (fusion predict_flow0)", (SINTEL_N, 16, SINTEL_H, SINTEL_W), (2, 16, 3, 3), 1, False, 1),
    ("k4/s2 deconv 162->16 (fusion deconv0)", (SINTEL_N, 162, SINTEL_H // 2, SINTEL_W // 2), (162, 16, 4, 4), 0,
     True, 1),
    ("k4/s2 deconv 2->2 (fusion upsample_flow1to0)", (SINTEL_N, 2, SINTEL_H // 2, SINTEL_W // 2), (2, 2, 4, 4), 0,
     False, 1),
)
# limits on the kernels' max abs error against the plain versions, times max|ref|
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# bytes per element and peak operations per second of each type
DTYPE_PEAKS = {torch.float32: (4, PEAK_F32_FLOPS), torch.bfloat16: (2, PEAK_BF16_FLOPS)}


def phase_head_kernels(dev: torch.device, card: str) -> dict:
    """K3 at each Sintel b4 geometry against its plain version (float32 and
    bfloat16), with times beside the plain version, the cuDNN calls and the
    bounds, then K4 (``phase_fusion_head``). K3's entries, head_conv (float32, CUDA
    cores) and head_conv_bf16 (tensor cores), sum one forward's twelve
    launches; each one's error is the worst of its type's checks."""
    import torch.nn.functional as F

    from flownet2_tpu_torch.ops.fusion_head import fusion_head_cuda, fusion_head_plain, head_weights
    from flownet2_tpu_torch.ops.head_conv import (
        head_conv2d_cuda, head_conv2d_plain, head_deconv2d_cuda, head_deconv2d_plain,
    )

    g = torch.Generator().manual_seed(SEED + 5)
    totals = {dtype: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0.0, flops=0.0)
              for dtype in DTYPE_PEAKS}
    worst = dict.fromkeys(DTYPE_PEAKS, 0.0)
    for label, x_shape, w_shape, stride, leaky, count in HEAD_GEOMETRIES:
        deconv = stride == 0
        x32 = torch.randn(x_shape, generator=g).to(dev)
        w32 = (torch.randn(w_shape, generator=g) * 0.1).to(dev)
        b32 = torch.randn(w_shape[1] if deconv else w_shape[0], generator=g).to(dev)
        if deconv:
            kernel = lambda x, w, b: head_deconv2d_cuda(x, w, b, leaky=leaky)  # noqa: E731
            plain = lambda x, w, b: head_deconv2d_plain(x, w, b, leaky=leaky)  # noqa: E731
            library = lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2, padding=1)  # noqa: E731
        else:
            kernel = lambda x, w, b: head_conv2d_cuda(x, w, b, stride=stride, leaky=leaky)  # noqa: E731
            plain = lambda x, w, b: head_conv2d_plain(x, w, b, stride=stride, leaky=leaky)  # noqa: E731
            library = lambda x, w, b: F.conv2d(x, w, b, stride=stride, padding=w_shape[-1] // 2)  # noqa: E731
        errs = []
        for dtype, rel in REL_TOL.items():
            args = tuple(t.to(dtype) for t in (x32, w32, b32))
            got = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            check(got.shape == ref.shape and got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"head_conv {label} {dtype}: shape, dtype, finiteness")
            err, top = abs_err_and_scale(got, ref)
            check(err <= rel * top, f"head_conv {label} {dtype}: max abs err {err} > {rel * top}")
            errs.append(f"{str(dtype)[6:]} {err:.3g} (tol {rel * top:.3g})")
            worst[dtype] = max(worst[dtype], err)
            out_numel = got.numel()
            del got, ref, args
        print(f"[kernels] head_conv {label}, x {tuple(x_shape)}: max abs err {'; '.join(errs)}")
        cout, cin = (w_shape[1], w_shape[0]) if deconv else w_shape[:2]
        taps = 4 if deconv else w_shape[2] * w_shape[3]
        flops = 2 * out_numel * cin * taps
        for dtype, (size, peak) in DTYPE_PEAKS.items():
            args = tuple(t.to(dtype) for t in (x32, w32, b32))
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            library_ms = cuda_ms(lambda: library(*args))
            nbytes = size * (x32.numel() + w32.numel() + b32.numel() + out_numel)
            b = bound(nbytes, flops, peak)
            print(f"[kernels]   {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN call "
                  f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.2f} TFLOP/s; {count} per forward ({card})")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", b["bound_ms"]), ("bytes", nbytes), ("flops", flops)):
                totals[dtype][key] += count * v
            del args
        del x32, w32, b32
        torch.cuda.empty_cache()
    results = {}
    for dtype, name, source in ((torch.float32, "head_conv", "head_conv.cu"),
                                (torch.bfloat16, "head_conv_bf16", "head_conv_tc.cu")):
        t = totals[dtype]
        print(f"[kernels] {name}, one Sintel b4 forward's 12 launches, {str(dtype)[6:]}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, cuDNN calls {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['flops'] / 1e9:.1f} GFLOP, {t['bytes'] / 1e9:.2f} GB) ({card})")
        results[name] = dict(
            name=name, route="cuda", source=f"flownet2_tpu_torch/csrc/{source}",
            replaces="flownet2_tpu/ops/pallas/s2d_conv.py:153", max_abs_err=worst[dtype], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=bound(t["bytes"], t["flops"], DTYPE_PEAKS[dtype][1])["bound_by"], library_ms=t["library_ms"],
        )

    results["fusion_head"] = phase_fusion_head(dev, card, g)
    return results


# K4's geometries: (label, N, full-resolution H, W)
FUSION_HEAD_GEOMETRIES = (("Sintel b4", SINTEL_N, SINTEL_H, SINTEL_W), ("448x320 b8", N, H, W))


def fusion_head_flops(n: int, h: int, w: int) -> float:
    """K4's useful operations: multiply-adds per output value times outputs
    of inter_conv1 and predict_flow1 (half resolution), deconv0 and
    upsample_flow1to0 (4 taps a phase), inter_conv0 and predict_flow0."""
    hw, hw2 = h * w, h * w // 4
    return 2 * n * (hw2 * (32 * 162 * 9 + 2 * 32 * 9) + hw * (16 * 162 * 4 + 2 * 2 * 4 + 16 * 82 * 9 + 2 * 16 * 9))


def phase_fusion_head(dev: torch.device, card: str, g: torch.Generator) -> dict:
    """K4 at Sintel b4 and 448x320 b8, float32 and bfloat16, against its
    plain version (the six layers' plain versions), with times beside the
    plain version, the unfused route it replaces (``FlowNetFusion.
    head_unfused``: K3 and cuDNN at Sintel width, cuDNN alone at 448) and
    the bound in each dtype. The JSON entry's plain keys are float32 at
    Sintel b4; ``*_bf16`` keys bfloat16 there; ``at_448x320_b8`` both at the
    other geometry."""
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.models import FlowNet2
    from flownet2_tpu_torch.ops.fusion_head import fusion_head_cuda, fusion_head_plain, head_weights

    flat = init_params("flownet2", seed=SEED)
    rng = np.random.default_rng(SEED + 6)
    for key in flat:
        if key.startswith("fusion/") and key.endswith("/b"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32) * 0.3
    with torch.device("meta"):
        net = FlowNet2()
    fusion32 = load_into(net, flat).fusion.to(dev)
    entry = dict(name="fusion_head", route="cuda", source="flownet2_tpu_torch/csrc/fusion_head.cu",
                 source_bf16="flownet2_tpu_torch/csrc/fusion_head_tc.cu",
                 replaces="flownet2_tpu/ops/pallas/fusion_head.py:353", library_ms=None)
    for label, n_, h_, w_ in FUSION_HEAD_GEOMETRIES:
        cat32 = torch.randn(n_, 162, h_ // 2, w_ // 2, generator=g).to(dev)
        c032 = torch.randn(n_, 64, h_, w_, generator=g).to(dev)
        flops = fusion_head_flops(n_, h_, w_)
        row = {}
        for dtype, rel in REL_TOL.items():
            fusion = copy.deepcopy(fusion32).to(dtype)
            weights = head_weights(fusion)
            cat1, c0 = cat32.to(dtype), c032.to(dtype)
            errs = []
            with torch.no_grad():
                got = fusion_head_cuda(cat1, c0, *weights)
                torch.cuda.synchronize()
                ref = fusion_head_plain(cat1, c0, *weights)
                worst = 0.0
                for what, x, y in zip(("flow0", "flow1"), got, ref):
                    check(x.shape == y.shape and x.dtype == dtype and bool(torch.isfinite(x).all()),
                          f"fusion_head {label} {what} {dtype}: shape, dtype, finiteness")
                    err, top = abs_err_and_scale(x, y)
                    check(err <= rel * top, f"fusion_head {label} {what} {dtype}: max abs err {err} > {rel * top}")
                    errs.append(f"{what} {err:.3g} (tol {rel * top:.3g})")
                    worst = max(worst, err)
                del got, ref
                ms = cuda_ms(lambda: fusion_head_cuda(cat1, c0, *weights))
                plain_ms = cuda_ms(lambda: fusion_head_plain(cat1, c0, *weights))
                unfused_ms = cuda_ms(lambda: fusion.head_unfused(cat1, c0))
            size, peak = DTYPE_PEAKS[dtype]
            nbytes = size * (cat1.numel() + c0.numel() + sum(t.numel() for t in weights) + n_ * 2 * h_ * w_ * 5 // 4)
            b = bound(nbytes, flops, peak)
            print(f"[kernels] fusion_head {label} {str(dtype)[6:]}, concat1 {tuple(cat1.shape)}, c0 {tuple(c0.shape)}: "
                  f"max abs err {'; '.join(errs)}; kernel {ms:.4f} ms, plain (the six layers' plain versions) "
                  f"{plain_ms:.4f} ms, unfused route (head_unfused) {unfused_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{flops / ms / 1e9:.2f} TFLOP/s; fused {'wins' if ms < unfused_ms else 'loses'} ({card})")
            suffix = "" if dtype == torch.float32 else "_bf16"
            row.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms, f"unfused_ms{suffix}": unfused_ms,
                        f"bound_ms{suffix}": b["bound_ms"], f"bound_by{suffix}": b["bound_by"],
                        f"max_abs_err{suffix}": worst})
            del cat1, c0, fusion, weights
        if label == "Sintel b4":
            entry.update(row)
        else:
            entry["at_448x320_b8"] = row
        del cat32, c032
        torch.cuda.empty_cache()
    del fusion32, net
    torch.cuda.empty_cache()
    return entry


def synthetic_pairs(n: int, h: int = H, w: int = W) -> tuple[np.ndarray, np.ndarray]:
    """Seeded smooth RGB textures (0-255) and copies shifted by a few pixels."""
    rng = np.random.default_rng(SEED)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img0 = np.zeros((n, h, w, 3), np.float32)
    for k in range(6):
        f = rng.uniform(0.01, 0.08, (n, 1, 1, 3))
        p = rng.uniform(0, 6.283, (n, 1, 1, 3))
        img0 += np.sin(xs[None, ..., None] * f + ys[None, ..., None] * f[..., ::-1] * (k % 3) + p)
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255
    img1 = np.roll(img0, (2, 3), axis=(1, 2)) + rng.normal(0, 2, img0.shape).astype(np.float32)
    return img0, np.clip(img1, 0, 255).astype(np.float32)


def phase_slice(dev: torch.device, card: str, kernels: dict) -> dict:
    from flownet2_tpu_torch.checkpoint import init_params
    from flownet2_tpu_torch.core.flow_io import read_flo, write_ppm
    from flownet2_tpu_torch.inference import FlowRunner

    print(f"[slice] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    params = init_params("flownet2", seed=SEED)
    img0, img1 = synthetic_pairs(N)
    runner = FlowRunner("flownet2", params, device=dev)

    reset_inference_counts()
    flow = runner.batch(img0, img1)
    got = inference_counts()
    kernels["flow_warp"]["launches"] = got["flow_warp"]
    kernels["correlation"]["launches"] = got["correlation"]
    print(f"[slice] FlowNet2 f32 {N}x{H}x{W}: flow {flow.shape}, launches: {got}")
    expected = dict(flow_warp=4, correlation=1, head_conv=0, fusion_head=0, correlation_1d=0)
    check(got == expected, f"launches {got}, expected {expected} (the head kernels route only above width 512)")
    check(flow.shape == (N, H, W, 2) and np.isfinite(flow).all(), "f32 flow shape or finiteness")

    t0 = time.perf_counter()
    ref0 = FlowRunner("flownet2", params, device="cpu")(img0[0], img1[0])
    epe = float(np.sqrt(((flow[0] - ref0) ** 2).sum(-1)).mean())
    print(f"[slice] pair 0 vs the port on the CPU (plain versions, {time.perf_counter() - t0:.1f} s): "
          f"mean EPE {epe:.3g} px (limit 1e-2); mean |flow| {np.abs(flow[0]).mean():.3g} px")
    check(epe <= 1e-2, f"card vs CPU mean EPE {epe} > 1e-2")

    runner_bf16 = FlowRunner("flownet2", params, device=dev, dtype="bfloat16")
    flow_bf16 = runner_bf16.batch(img0, img1)
    check(flow_bf16.shape == (N, H, W, 2) and np.isfinite(flow_bf16).all(), "bf16 flow shape or finiteness")
    print(f"[slice] FlowNet2 bf16: finite, {flow_bf16.shape}; mean EPE vs f32 "
          f"{float(np.sqrt(((flow_bf16 - flow) ** 2).sum(-1)).mean()):.3g} px (random weights: not evidence)")

    with tempfile.TemporaryDirectory() as tmp:
        a, b, out = (os.path.join(tmp, f) for f in ("a.ppm", "b.ppm", "out.flo"))
        write_ppm(a, img0[0].astype(np.uint8))
        write_ppm(b, img1[0].astype(np.uint8))
        cmd = [sys.executable, "-m", "flownet2_tpu_torch.cli.run_flownet", "random", "flownet2", a, b, out,
               "--gpu", "0"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        magic, w, h, size = flo_header(out)
        check(magic == b"PIEH" and (w, h) == (W, H) and size == 12 + W * H * 8,
              f".flo header {magic!r} {w}x{h}, {size} bytes")
        check(np.isfinite(read_flo(out)).all(), "CLI flow finiteness")
    print(f"[slice] CLI: {' '.join(cmd[1:4])} ... --gpu 0 -> .flo PIEH {w}x{h}, {size} bytes")

    timings = {}
    i0 = torch.as_tensor(img0, device=dev)
    i1 = torch.as_tensor(img1, device=dev)
    for label, r in (("f32", runner), ("bf16", runner_bf16)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: r.run(i0, i1), warmup=3, runs=7)
        mem = torch.cuda.max_memory_allocated()
        timings[label] = dict(ms=ms, pairs_per_s=N / (ms / 1e3), max_memory_allocated=mem)
        print(f"[times] FlowNet2 {label} {W}x{H} b{N}: {ms:.3f} ms/batch, {N / (ms / 1e3):.2f} pairs/s, "
              f"max_memory_allocated {mem / 2**20:.1f} MiB ({card})")
    return timings


def inference_counts() -> dict:
    """Launches of the forward kernels since their counts were last reset."""
    from flownet2_tpu_torch.ops.correlation import correlation_1d_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.fusion_head import fusion_head_cuda
    from flownet2_tpu_torch.ops.head_conv import head_launches
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda

    return dict(flow_warp=flow_warp_cuda.launches, correlation=correlation_cuda.launches,
                head_conv=head_launches(), fusion_head=fusion_head_cuda.launches,
                correlation_1d=correlation_1d_cuda.launches)


def reset_inference_counts() -> None:
    from flownet2_tpu_torch.ops.correlation import correlation_1d_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.fusion_head import fusion_head_cuda
    from flownet2_tpu_torch.ops.head_conv import head_conv2d_cuda, head_deconv2d_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda

    for k in (flow_warp_cuda, correlation_cuda, head_conv2d_cuda, head_deconv2d_cuda, fusion_head_cuda,
              correlation_1d_cuda):
        k.launches = 0


def flo_header(path: str) -> tuple[bytes, int, int, int]:
    """(magic, width, height, file size) of a .flo file."""
    with open(path, "rb") as f:
        magic, w, h = f.read(4), *struct.unpack("<ii", f.read(8))
    return magic, w, h, os.path.getsize(path)


def write_jobs(tmp: str, frames) -> tuple[str, list]:
    """Each (img0, img1) of ``frames`` as job{j}_a.ppm / job{j}_b.ppm in
    ``tmp`` and a run_flownet_many list file naming job{j}_out.flo; returns
    the list file and each output's (path, width, height)."""
    from flownet2_tpu_torch.core.flow_io import write_ppm

    lines, outs = [], []
    for j, (a, b) in enumerate(frames):
        pa, pb, out = (os.path.join(tmp, f"job{j}_{x}") for x in ("a.ppm", "b.ppm", "out.flo"))
        write_ppm(pa, a.astype(np.uint8))
        write_ppm(pb, b.astype(np.uint8))
        lines.append(f"{pa} {pb} {out}")
        outs.append((out, a.shape[1], a.shape[0]))
    listfile = os.path.join(tmp, "jobs.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    return listfile, outs


def phase_sintel(dev: torch.device, card: str, kernels: dict) -> dict:
    """FlowNet2 at Sintel size through FlowRunner (1024x436 frames, adapted
    to 1024x448, b4), float32 and bfloat16, without and with the fused
    head; then run_flownet_many over two Sintel-size jobs and one 448x320."""
    from flownet2_tpu_torch.checkpoint import init_params
    from flownet2_tpu_torch.core.flow_io import read_flo
    from flownet2_tpu_torch.inference import FlowRunner

    params = init_params("flownet2", seed=SEED)
    fh, fw = SINTEL_FRAME
    img0, img1 = synthetic_pairs(SINTEL_N, fh, fw)
    runners, flows = {}, {}
    for dtype in ("float32", "bfloat16"):
        for fused in (False, True):
            label = f"{'f32' if dtype == 'float32' else 'bf16'}{' fused head' if fused else ''}"
            runners[label] = r = FlowRunner("flownet2", params, device=dev, dtype=dtype, fusion_head=fused)
            reset_inference_counts()
            flows[label] = flow = r.batch(img0, img1)
            got = inference_counts()
            expected = dict(flow_warp=4, correlation=1, head_conv=8 if fused else 12, fusion_head=int(fused),
                            correlation_1d=0)
            print(f"[sintel] FlowNet2 {label} {fw}x{fh} b{SINTEL_N}: flow {flow.shape}, launches {got}")
            check(got == expected, f"{label}: launches {got}, expected {expected}")
            check(flow.shape == (SINTEL_N, fh, fw, 2) and np.isfinite(flow).all(), f"{label}: flow shape, finiteness")
            if label == "f32":
                kernels["head_conv"]["launches"] = got["head_conv"]
            if label == "bf16":
                kernels["head_conv_bf16"]["launches"] = got["head_conv"]
            if label == "f32 fused head":
                kernels["fusion_head"]["launches"] = got["fusion_head"]

    def epe(a, b):
        return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())

    t0 = time.perf_counter()
    ref0 = FlowRunner("flownet2", params, device="cpu")(img0[0], img1[0])
    card_cpu = epe(flows["f32"][0], ref0)
    print(f"[sintel] pair 0, card vs the port on the CPU ({time.perf_counter() - t0:.1f} s on the CPU): mean EPE "
          f"{card_cpu:.3g} px (limit 1e-2); mean |flow| {np.abs(ref0).mean():.3g} px")
    check(card_cpu <= 1e-2, f"Sintel card vs CPU mean EPE {card_cpu} > 1e-2")
    fused_unfused = epe(flows["f32 fused head"], flows["f32"])
    print(f"[sintel] f32 fused head vs unfused on the card, {SINTEL_N} pairs: mean EPE {fused_unfused:.3g} px "
          f"(limit 1e-3); bf16 fused vs unfused {epe(flows['bf16 fused head'], flows['bf16']):.3g} px, bf16 vs f32 "
          f"{epe(flows['bf16'], flows['f32']):.3g} px (random weights: not evidence)")
    check(fused_unfused <= 1e-3, f"fused vs unfused mean EPE {fused_unfused} > 1e-3")

    timings = {}
    i0, i1 = torch.as_tensor(img0, device=dev), torch.as_tensor(img1, device=dev)
    for label, r in runners.items():
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: r.run(i0, i1), warmup=3, runs=7)
        mem = torch.cuda.max_memory_allocated()
        timings[label] = dict(ms=ms, pairs_per_s=SINTEL_N / (ms / 1e3), max_memory_allocated=mem)
        print(f"[times] FlowNet2 Sintel {label} {fw}x{fh} b{SINTEL_N}: {ms:.3f} ms/batch, "
              f"{SINTEL_N / (ms / 1e3):.2f} pairs/s, max_memory_allocated {mem / 2**20:.1f} MiB ({card})")
    del runners, i0, i1
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        small0, small1 = synthetic_pairs(1)
        listfile, outs = write_jobs(tmp, [(img0[0], img1[0]), (img0[1], img1[1]), (small0[0], small1[0])])
        cmd = [sys.executable, "-m", "flownet2_tpu_torch.cli.run_flownet_many", "random", "flownet2", listfile,
               "--gpu", "0"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"run_flownet_many exit {proc.returncode}: {proc.stderr[-2000:]}")
        for out, w, h in outs:
            magic, fw_, fh_, size = flo_header(out)
            check(magic == b"PIEH" and (fw_, fh_) == (w, h) and size == 12 + w * h * 8,
                  f"{out}: .flo header {magic!r} {fw_}x{fh_}, {size} bytes")
            check(np.isfinite(read_flo(out)).all(), f"{out}: finiteness")
    print(f"[sintel] CLI: {' '.join(cmd[1:4])} jobs.txt --gpu 0 -> 3 .flo files (2 at {fw}x{fh}, 1 at {W}x{H}), "
          f"PIEH headers, finite")
    return timings


def phase_dispnet(dev: torch.device, card: str, kernels: dict) -> dict:
    """DispNetC through FlowRunner on FlyingThings3D-size frames (960x540,
    adapted to 960x576, b4), float32 and bfloat16: one launch of the 1-D
    forward a batch and none of the other kernels; pair 0 on the card
    against the port on the CPU (mean EPE <= 1e-2 px over both output
    channels); timed. Then the run_flownet CLI with dispnetc on a KITTI 2015
    size pair (1242x375) and run_flownet_many over two jobs (1242x375 and
    960x540)."""
    from flownet2_tpu_torch.checkpoint import init_params
    from flownet2_tpu_torch.core.flow_io import read_flo
    from flownet2_tpu_torch.inference import FlowRunner

    params = init_params("dispnetc", seed=SEED)
    fh, fw = DISP_FRAME
    img0, img1 = synthetic_pairs(DISP_N, fh, fw)
    runners, flows = {}, {}
    expected = dict(flow_warp=0, correlation=0, head_conv=0, fusion_head=0, correlation_1d=1)
    for dtype in ("float32", "bfloat16"):
        label = "f32" if dtype == "float32" else "bf16"
        runners[label] = r = FlowRunner("dispnetc", params, device=dev, dtype=dtype)
        reset_inference_counts()
        flows[label] = flow = r.batch(img0, img1)
        got = inference_counts()
        print(f"[dispnet] DispNetC {label} {fw}x{fh} b{DISP_N}: flow {flow.shape}, launches {got}")
        check(got == expected, f"dispnetc {label}: launches {got}, expected {expected}")
        check(flow.shape == (DISP_N, fh, fw, 2) and np.isfinite(flow).all(),
              f"dispnetc {label}: flow shape, finiteness")
        if label == "f32":
            kernels["correlation_1d"]["launches"] = got["correlation_1d"]

    t0 = time.perf_counter()
    ref0 = FlowRunner("dispnetc", params, device="cpu")(img0[0], img1[0])
    epe = float(np.sqrt(((flows["f32"][0] - ref0) ** 2).sum(-1)).mean())
    print(f"[dispnet] pair 0, card vs the port on the CPU ({time.perf_counter() - t0:.1f} s on the CPU): mean EPE "
          f"{epe:.3g} px (limit 1e-2); mean |disparity| {np.abs(ref0[..., 0]).mean():.3g} px")
    check(epe <= 1e-2, f"dispnetc card vs CPU mean EPE {epe} > 1e-2")

    timings = {}
    i0, i1 = torch.as_tensor(img0, device=dev), torch.as_tensor(img1, device=dev)
    for label, r in runners.items():
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: r.run(i0, i1), warmup=3, runs=7)
        mem = torch.cuda.max_memory_allocated()
        timings[label] = dict(ms=ms, pairs_per_s=DISP_N / (ms / 1e3), max_memory_allocated=mem)
        print(f"[times] DispNetC {label} {fw}x{fh} b{DISP_N}: {ms:.3f} ms/batch, {DISP_N / (ms / 1e3):.2f} pairs/s, "
              f"max_memory_allocated {mem / 2**20:.1f} MiB ({card})")
    del runners, i0, i1
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        kh, kw = KITTI_FRAME
        k0, k1 = synthetic_pairs(1, kh, kw)
        listfile, outs = write_jobs(tmp, [(k0[0], k1[0]), (img0[0], img1[0])])
        single = os.path.join(tmp, "kitti.flo")
        one = [sys.executable, "-m", "flownet2_tpu_torch.cli.run_flownet", "random", "dispnetc",
               *(os.path.join(tmp, f"job0_{x}.ppm") for x in "ab"), single, "--gpu", "0"]
        many = [sys.executable, "-m", "flownet2_tpu_torch.cli.run_flownet_many", "random", "dispnetc", listfile,
                "--gpu", "0"]
        for cmd in (one, many):
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"{cmd[2]} dispnetc exit {proc.returncode}: {proc.stderr[-2000:]}")
        for out, w, h in [(single, kw, kh)] + outs:
            magic, fw_, fh_, size = flo_header(out)
            check(magic == b"PIEH" and (fw_, fh_) == (w, h) and size == 12 + w * h * 8,
                  f"{out}: .flo header {magic!r} {fw_}x{fh_}, {size} bytes")
            check(np.isfinite(read_flo(out)).all(), f"{out}: finiteness")
    print(f"[dispnet] CLI: run_flownet random dispnetc on a {kw}x{kh} pair --gpu 0 -> .flo PIEH {kw}x{kh}; "
          f"run_flownet_many random dispnetc jobs.txt --gpu 0 -> 2 .flo files ({kw}x{kh}, {fw}x{fh}), finite")
    return timings


def stereo_batch(n: int, h: int, w: int, seed: int) -> dict:
    """A seeded synthetic left/right/disparity batch: a smooth texture as the
    left frame, the right frame sampled from it along a smooth one-sided
    disparity of 2-30 px (right at x shows what left shows at x + d), and
    -d as the (N, H, W, 1) disparity (the DisparityData sign)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    left, right, disp = (np.zeros((n, h, w, k), np.float32) for k in (3, 3, 1))
    for i in range(n):
        texture = random_texture(rng)
        f, p = rng.uniform(0.005, 0.02, 2), rng.uniform(0, 2 * np.pi, 2)
        d = 16 + 14 * np.sin(xs * f[0] + p[0]) * np.cos(ys * f[1] + p[1])
        left[i], right[i], disp[i, ..., 0] = texture(xs, ys), texture(xs + d, ys), -d
    return {"img0": left, "img1": right, "flow": disp}


def phase_dispnet_train(dev: torch.device, card: str, kernels: dict) -> dict:
    """DispNetC Solver steps (Adam, float32) at the FlyingThings3D training
    crop 768x384 b4 on synthetic left/right/disparity batches: one launch of
    the 1-D forward and one of its backward a step, and no other kernel;
    then one step's loss and gradients on the card against the port on the
    CPU (loss rtol 1e-4; relative L2 of all tensors and of the median tensor
    <= 1e-3, as phase_train holds them); a timed step."""
    from flownet2_tpu_torch.ops.correlation import correlation_1d_backward_cuda, correlation_1d_cuda
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import dispnet_c_loss

    sched = FLOWNET_SCHEDULES["S_long"]
    config = SolverConfig(solver_type="adam", lr_policy=sched["policy"], base_lr=sched["base_lr"],
                          gamma=sched["gamma"], stepvalues=sched["stepvalues"], max_iter=sched["max_iter"],
                          momentum=0.9, momentum2=0.999)
    n_, h_, w_ = DISP_TRAIN_N, DISP_TRAIN_H, DISP_TRAIN_W
    batches = [stereo_batch(n_, h_, w_, SEED + 20 + i) for i in range(3)]
    net = _net("dispnetc")
    solver = Solver(config, dispnet_c_loss, net, device=dev)
    reset_inference_counts()
    correlation_1d_backward_cuda.launches = 0
    losses = [solver.step({k: torch.as_tensor(v, device=dev) for k, v in b.items()})[0].item() for b in batches[:2]]
    got = inference_counts(), correlation_1d_backward_cuda.launches
    print(f"[train] dispnetc f32 {w_}x{h_} b{n_}: losses {', '.join(f'{x:.6g}' for x in losses)}; launches in 2 "
          f"steps {got[0]}, 1-D backward {got[1]}")
    check(all(np.isfinite(losses)), "dispnetc: loss not finite")
    expected = dict(flow_warp=0, correlation=0, head_conv=0, fusion_head=0, correlation_1d=2)
    check(got == (expected, 2), f"dispnetc train: launches {got}, expected {expected} and 2 backward")
    kernels["correlation_1d_backward"]["launches"] = got[1] // 2
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batches[2].items()}
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: solver.step(batch), warmup=2, runs=5)
    mem = torch.cuda.max_memory_allocated()
    timings = {"dispnetc f32": dict(ms=ms, pairs_per_s=n_ / (ms / 1e3), max_memory_allocated=mem)}
    print(f"[times] train step dispnetc f32 {w_}x{h_} b{n_}: {ms:.3f} ms/step, {n_ / (ms / 1e3):.2f} pairs/s, "
          f"max_memory_allocated {mem / 2**20:.1f} MiB ({card})")
    del solver, net, batch
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    loss, grads = loss_and_grads("dispnetc", SEED, dispnet_c_loss, batches[0], dev)
    t0 = time.perf_counter()
    ref_loss, ref_grads = loss_and_grads("dispnetc", SEED, dispnet_c_loss, batches[0], "cpu")
    torch.backends.cudnn.deterministic = False
    e = grad_errors(grads, ref_grads)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"[train] dispnetc f32 step {w_}x{h_} b{n_}, card vs CPU ({time.perf_counter() - t0:.1f} s on the CPU): "
          f"loss {loss:.6g} vs {ref_loss:.6g} (rel {rel:.3g}, limit 1e-4); gradients of {e['tensors']} tensors: "
          f"relative L2 of all {e['all']:.3g} (limit 1e-3), median tensor {e['median']:.3g} (limit 1e-3), worst "
          f"tensor {e['worst_key']} {e['worst']:.3g}, {e['above_1e-3']} tensor(s) above 1e-3")
    check(rel <= 1e-4, f"dispnetc: card vs CPU loss rel err {rel}")
    check(e["all"] <= 1e-3, f"dispnetc: card vs CPU gradients, relative L2 of all {e['all']}")
    check(e["median"] <= 1e-3, f"dispnetc: card vs CPU gradients, median tensor {e['median']}")
    return timings


def random_texture(rng: np.random.Generator):
    """texture(x, y) -> (..., 3) RGB in 0-255: five seeded slanted plane
    waves per channel, defined at any real coordinates."""
    freq = rng.uniform(0.02, 0.12, (5, 3))
    phase = rng.uniform(0, 2 * np.pi, (5, 3))
    slant = rng.uniform(-1, 1, (5, 3))

    def texture(x, y):
        waves = sum(np.sin(x[..., None] * freq[k] + y[..., None] * freq[k] * slant[k] + phase[k]) for k in range(5))
        return np.clip(127.5 + 25 * waves, 0, 255)

    return texture


def write_chairs(root: str, n: int, h: int = H, w: int = W) -> None:
    """n FlyingChairs-layout pairs at hxw: a seeded texture, the second
    frame sampled from it along a smooth known flow, and that flow as -gt.flo
    (frame 1 at x + flow(x) shows what frame 0 shows at x)."""
    from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm

    rng = np.random.default_rng(SEED + 4)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        texture = random_texture(rng)
        amp, (fx, fy), (px, py) = rng.uniform(2, 12, 2), rng.uniform(0.005, 0.02, 2), rng.uniform(0, 6.28, 2)
        flow = np.stack([amp[0] * np.sin(ys * fy + px), amp[1] * np.cos(xs * fx + py)], axis=-1).astype(np.float32)
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), texture(xs, ys).astype(np.uint8))
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"),
                  texture(xs - flow[..., 0], ys - flow[..., 1]).astype(np.uint8))
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), flow)


def _net(model: str, seed: int = SEED):
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.models import NETS

    with torch.device("meta"):
        net = NETS[model]()
    return load_into(net, init_params(model, seed=seed))


def loss_and_grads(model: str, seed: int, loss_fn, batch: dict, device) -> tuple[float, dict]:
    """One float32 loss and every parameter's gradient of ``model`` (seeded weights)."""
    net = _net(model, seed).to(device)
    loss, _ = loss_fn(net, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in net.named_parameters()}


def grad_errors(grads: dict, ref: dict) -> dict:
    """Relative L2 error of ``grads`` against ``ref``: of all tensors
    together, of the median tensor, of the worst tensor (and its name), and
    the count of tensors above 1e-3."""
    per = {k: ((grads[k] - r).norm() / r.norm()).item() for k, r in ref.items()}
    diff = sum(((grads[k] - r) ** 2).sum().item() for k, r in ref.items())
    norm = sum((r ** 2).sum().item() for r in ref.values())
    worst_key = max(per, key=per.get)
    return {"all": (diff / norm) ** 0.5, "median": statistics.median(per.values()), "worst_key": worst_key,
            "worst": per[worst_key], "above_1e-3": sum(v > 1e-3 for v in per.values()), "tensors": len(per),
            "per_tensor": per}


def phase_train(dev: torch.device, card: str, kernels: dict) -> dict:
    from flownet2_tpu_torch.data import BatchLoader, FlyingChairs
    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import LOSSES, flownet2_loss, flownet_c_loss, with_compute_dtype

    counters = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)

    def counts():
        return tuple(k.launches for k in counters)

    sched = FLOWNET_SCHEDULES["S_long"]
    config = SolverConfig(solver_type="adam", lr_policy=sched["policy"], base_lr=sched["base_lr"],
                          gamma=sched["gamma"], stepvalues=sched["stepvalues"], max_iter=sched["max_iter"],
                          momentum=0.9, momentum2=0.999)
    timings = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chairs_")
    try:
        write_chairs(tmp, 16)
        # one worker thread, so the batches come in the same order every run
        loader = iter(BatchLoader(FlyingChairs(tmp), N, crop=(H, W), shuffle_seed=SEED, num_threads=1))
        first = next(loader)
        check(first["img0"].shape == (N, H, W, 3) and first["flow"].shape == (N, H, W, 2), "loader batch shape")

        runs = [  # label, model, loss, trainable sub-net, steps, launches per step (warp, warp bwd, corr, corr bwd)
            ("flownetc f32", "flownetc", flownet_c_loss, None, 3, (0, 0, 1, 1)),
            ("flownetc bf16", "flownetc", with_compute_dtype(flownet_c_loss, torch.bfloat16), None, 3,
             (0, 0, 1, 1)),
            ("joint f32", "flownet2", flownet2_loss, None, 2, (4, 4, 1, 1)),
            ("flownet2-s1 f32", "flownet2", LOSSES["flownet2-s1"], "flownets_1", 1, (1, 0, 1, 0)),
        ]
        for label, model, loss_fn, sub, steps, per_step in runs:
            net = _net(model)
            solver = Solver(config, loss_fn, net, device=dev, trainable=None if sub is None else getattr(net, sub))
            for k in counters:
                k.launches = 0
            losses = [solver.step(next(loader))[0].item()]
            first_step = counts()
            losses += [solver.step(next(loader))[0].item() for _ in range(steps - 1)]
            got = counts()
            print(f"[train] {label} {W}x{H} b{N}: losses {', '.join(f'{x:.6g}' for x in losses)}; launches "
                  f"(warp, warp bwd, corr, corr bwd) {first_step} in the first step, {got} in {steps} step(s)")
            check(all(np.isfinite(losses)), f"{label}: loss not finite")
            check(first_step == per_step and got == tuple(steps * c for c in per_step),
                  f"{label}: launches {first_step} in one step, {got} in {steps}; expected {per_step} per step")
            if label == "joint f32":  # the training path's launches of the backward kernels, per step
                kernels["flow_warp_backward"]["launches"] = first_step[1]
                kernels["correlation_backward"]["launches"] = first_step[3]
            batch = {k: torch.as_tensor(v, device=dev) for k, v in next(loader).items()}
            if label != "flownet2-s1 f32":
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: solver.step(batch), warmup=2, runs=5)
                mem = torch.cuda.max_memory_allocated()
                timings[label] = dict(ms=ms, pairs_per_s=N / (ms / 1e3), max_memory_allocated=mem)
                print(f"[times] train step {label} {W}x{H} b{N}: {ms:.3f} ms/step, {N / (ms / 1e3):.2f} pairs/s, "
                      f"max_memory_allocated {mem / 2**20:.1f} MiB ({card})")
            del solver, net

        # One float32 step on the loader's first batch, card against the port
        # on the CPU, same weights. Here the random net's gradients are
        # ill-conditioned tensor by tensor: scaling the CPU's second frame by
        # 1 + 1e-6 moves 30 of the joint loss's 228 tensors by more than 1e-3
        # (kinks of leaky ReLUs and warp taps within float32 noise of their
        # inputs; scripts/probe_grads.py), and the card differs from the CPU
        # by as much. So the gradients are held as a whole: relative L2 over
        # all tensors together <= 1e-3 and the median tensor's <= 1e-3; the
        # worst tensor is printed.
        torch.backends.cudnn.deterministic = True
        for label, model, loss_fn in (("flownetc", "flownetc", flownet_c_loss),
                                      ("joint", "flownet2", flownet2_loss)):
            loss, grads = loss_and_grads(model, SEED, loss_fn, first, dev)
            t0 = time.perf_counter()
            ref_loss, ref_grads = loss_and_grads(model, SEED, loss_fn, first, "cpu")
            e = grad_errors(grads, ref_grads)
            rel = abs(loss - ref_loss) / abs(ref_loss)
            print(f"[train] {label} f32 step {W}x{H} b{N}, card vs CPU ({time.perf_counter() - t0:.1f} s on the "
                  f"CPU): loss {loss:.6g} vs {ref_loss:.6g} (rel {rel:.3g}, limit 1e-4); gradients of "
                  f"{e['tensors']} tensors: relative L2 of all {e['all']:.3g} (limit 1e-3), median tensor "
                  f"{e['median']:.3g} (limit 1e-3), worst tensor {e['worst_key']} {e['worst']:.3g}, "
                  f"{e['above_1e-3']} tensor(s) above 1e-3")
            check(rel <= 1e-4, f"{label}: card vs CPU loss rel err {rel}")
            check(e["all"] <= 1e-3, f"{label}: card vs CPU gradients, relative L2 of all {e['all']}")
            check(e["median"] <= 1e-3, f"{label}: card vs CPU gradients, median tensor {e['median']}")
        torch.backends.cudnn.deterministic = False

        snaps = os.path.join(tmp, "snapshots")
        cmd = [sys.executable, "-m", "flownet2_tpu_torch.cli.train", "--model", "flownetc", "--dataset",
               "flyingchairs", "--data-root", tmp, "--no-augment", "--batch", str(N), "--crop", f"{H}x{W}",
               "--snapshot-dir", snaps, "--display", "1", "--gpu", "0"]
        for extra in (["--max-iter", "4"], ["--max-iter", "6", "--snapshot", os.path.join(snaps, "iter_0000004")]):
            proc = subprocess.run(cmd + extra, cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"train CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        check("Iteration 5, loss" in proc.stdout and "Iteration 1," not in proc.stdout, "CLI resume from iteration 4")
        written = sorted(os.listdir(snaps))
        check(written == ["iter_0000004.npz", "iter_0000004.pt", "iter_0000006.npz", "iter_0000006.pt"],
              f"CLI snapshots {written}")
        print(f"[train] CLI: {' '.join(cmd[1:4])} ... --max-iter 4 --gpu 0, then --snapshot iter_0000004 to 6: "
              f"{', '.join(written)}; {proc.stdout.strip().splitlines()[-1]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return timings


def nested(flat: dict) -> dict:
    """Flat ``a/b/w`` weights -> {"a": {"b": {"w": ...}}}, as the exporters take them."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def flo_agreement(got: np.ndarray, ref: np.ndarray, what: str) -> str:
    """Equal .flo contents, bit for bit; where a kernel route is not bitwise
    deterministic, mean EPE <= 1e-6 px, with the reason printed."""
    check(got.shape == ref.shape and np.isfinite(got).all(), f"{what}: shape {got.shape} or finiteness")
    diff = float(np.abs(got - ref).max())
    if diff == 0:
        return "max abs difference 0"
    epe = float(np.sqrt(((got - ref) ** 2).sum(-1)).mean())
    print(f"[weights] {what}: max abs difference {diff:.3g}, not 0: cuDNN's default algorithms are not bitwise "
          f"deterministic (cudnn.deterministic is off, as a user runs); mean EPE {epe:.3g} px (limit 1e-6)")
    check(epe <= 1e-6, f"{what}: mean EPE {epe} > 1e-6")
    return f"mean EPE {epe:.3g} px"


def phase_weights(dev: torch.device, card: str) -> None:
    """Caffe weights through the port: seeded FlowNet2 weights written by the
    port's exporter as a merged .caffemodel and .caffemodel.h5 and as an
    .npz, each run through the run_flownet CLI on the card at FlyingChairs'
    512x384 (three equal .flo files); a standalone FlowNetC .caffemodel
    through FlowRunner at 448x320 b8 against its .npz (one correlation
    launch each)."""
    from flownet2_tpu_torch.checkpoint import flatten_params, init_params, load_params, save_params
    from flownet2_tpu_torch.core.flow_io import read_flo, write_ppm
    from flownet2_tpu_torch.inference import FlowRunner
    from flownet2_tpu_torch.models.export_caffe import (
        export_caffemodel,
        export_caffemodel_merged,
        export_caffemodel_merged_h5,
    )
    from flownet2_tpu_torch.models.import_caffe import import_caffemodel

    tmp = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        flat = init_params("flownet2", seed=SEED)
        files = {ext: os.path.join(tmp, "FlowNet2" + ext) for ext in (".caffemodel", ".caffemodel.h5", ".npz")}
        t0 = time.perf_counter()
        export_caffemodel_merged(nested(flat), files[".caffemodel"])
        export_caffemodel_merged_h5(nested(flat), files[".caffemodel.h5"])
        save_params(files[".npz"], flat)
        written = time.perf_counter() - t0
        imports = []
        for ext in (".caffemodel", ".caffemodel.h5"):
            t0 = time.perf_counter()
            got = flatten_params(import_caffemodel(files[ext], "flownet2"))
            imports.append(f"{ext} {time.perf_counter() - t0:.2f} s")
            check(got.keys() == flat.keys() and all(np.array_equal(got[k], flat[k]) for k in flat),
                  f"{ext}: the import differs from the exported weights")
        sizes = ", ".join(f"{e} {os.path.getsize(f) / 1e6:.1f} MB" for e, f in files.items())
        print(f"[weights] FlowNet2 seeded weights: {sizes} (written in {written:.1f} s); import {', '.join(imports)}, "
              "equal to the exported weights")

        fh, fw = CHAIRS_FRAME
        img0, img1 = synthetic_pairs(1, fh, fw)
        a, b = os.path.join(tmp, "a.ppm"), os.path.join(tmp, "b.ppm")
        write_ppm(a, img0[0].astype(np.uint8))
        write_ppm(b, img1[0].astype(np.uint8))
        flows = {}
        for ext, path in files.items():
            out = os.path.join(tmp, f"out{ext}.flo")
            cmd = [sys.executable, "-m", "flownet2_tpu_torch.cli.run_flownet", path, "flownet2", a, b, out,
                   "--gpu", "0"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"run_flownet {ext} exit {proc.returncode}: {proc.stderr[-2000:]}")
            flows[ext] = read_flo(out)
            print(f"[weights] run_flownet FlowNet2{ext} flownet2 a.ppm b.ppm out.flo --gpu 0 ({fw}x{fh}): "
                  f"{time.perf_counter() - t0:.1f} s with start-up, flow {flows[ext].shape}")
        for ext in (".caffemodel", ".caffemodel.h5"):
            print(f"[weights] .flo from {ext} vs from .npz: {flo_agreement(flows[ext], flows['.npz'], ext)}")

        c_flat = init_params("flownetc", seed=SEED)
        c_model, c_npz = os.path.join(tmp, "FlowNet2-C.caffemodel"), os.path.join(tmp, "FlowNet2-C.npz")
        export_caffemodel(nested(c_flat), c_model, bgr_slots={"conv1": 1})
        save_params(c_npz, c_flat)
        i0, i1 = synthetic_pairs(N)
        flows = {}
        for label, params in (("caffemodel", import_caffemodel(c_model, "flownetc")), ("npz", load_params(c_npz))):
            runner = FlowRunner("flownetc", params, device=dev)
            reset_inference_counts()
            flows[label] = runner.batch(i0, i1)
            got = inference_counts()
            expected = dict(flow_warp=0, correlation=1, head_conv=0, fusion_head=0, correlation_1d=0)
            check(got == expected, f"FlowNetC {label}: launches {got}, expected {expected}")
        agreement = flo_agreement(flows["caffemodel"], flows["npz"], "flownetc")
        print(f"[weights] FlowRunner('flownetc') {W}x{H} b{N} on FlowNet2-C.caffemodel "
              f"({os.path.getsize(c_model) / 1e6:.1f} MB) vs .npz: {agreement}; one correlation launch each")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main_in_process(main, argv: list) -> tuple[int, str]:
    """(exit code, standard output) of a CLI's ``main(argv)`` run in this
    process, so the kernels it launches are counted."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def train_cli_in_process(argv: list, counters: tuple) -> tuple[str, tuple]:
    """Run ``cli.train`` in this process, so its kernel launches can be
    counted: (its standard output, the launches of ``counters``)."""
    from flownet2_tpu_torch.cli.train import main as train_main

    for k in counters:
        k.launches = 0
    handlers = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGHUP)
    try:
        rc, out = main_in_process(train_main, argv)
    finally:
        signal.signal(signal.SIGINT, handlers[0])
        signal.signal(signal.SIGHUP, handlers[1])
    check(rc == 0, f"cli.train {' '.join(argv)}: exit {rc}")
    return out, tuple(k.launches for k in counters)


FEED_ROUNDS, FEED_BLOCK = 3, 8


def feed_times(fns: dict, strict: tuple = ()) -> dict:
    """ms a step of each feed in ``fns`` by :func:`step_times`, taken in
    turns: ``FEED_ROUNDS`` rounds run a block of ``FEED_BLOCK`` back-to-back
    steps of each feed after one warm-up step, in order on even rounds and
    reversed on odd ones; the feeds in ``strict`` under sync debug mode
    "error"."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(FEED_ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name] += step_times(fns[name], FEED_BLOCK, 1, strict=name in strict)
    return times


def record_feed_times(solver, make_loader, dev) -> dict:
    """:func:`feed_times` of ``solver``'s step on a card-resident batch,
    fed directly from a ``BatchLoader`` (``Solver.step`` uploads the host
    arrays) and fed through ``DevicePrefetcher``; the resident and the
    prefetch-fed steps under sync debug mode "error"."""
    from flownet2_tpu_torch.data import DevicePrefetcher

    first = iter(make_loader())
    resident = {k: torch.as_tensor(v).to(dev) for k, v in next(first).items()}
    first.close()
    direct = iter(make_loader())
    staged = iter(DevicePrefetcher(iter(make_loader()), device=dev))
    solver.sync_bound = 1 << 30  # each block ends in one sync, none inside it
    try:
        return feed_times({"resident": lambda: solver.step(resident), "direct": lambda: solver.step(next(direct)),
                           "prefetched": lambda: solver.step(next(staged))}, strict=("resident", "prefetched"))
    finally:
        staged.close()
        direct.close()


def prefetch_equality(dev, config, make_loss, start_net, host_batches: list) -> dict:
    """The batches ``DevicePrefetcher`` delivers against the same host
    arrays uploaded directly (max abs 0, dtypes and shapes equal), and the
    parameters after ``Solver.solve`` over them fed through it against two
    runs fed the host arrays directly, cuDNN deterministic: max abs 0, or
    within the two direct runs' spread. ``make_loss()`` gives each run its
    own objective (an augmented one keeps a noise generator)."""
    from flownet2_tpu_torch.data import DevicePrefetcher
    from flownet2_tpu_torch.train import Solver

    batch_diff = 0.0
    for got, src in zip(DevicePrefetcher(iter(host_batches), device=dev), host_batches):
        for k, v in src.items():
            ref = torch.as_tensor(v).to(dev)
            check(got[k].dtype == ref.dtype and got[k].shape == ref.shape,
                  f"prefetched {k} {got[k].dtype} {tuple(got[k].shape)}, direct {ref.dtype} {tuple(ref.shape)}")
            check(torch.equal(got[k].double().isnan(), ref.double().isnan()), f"prefetched {k}: NaN pattern")
            batch_diff = max(batch_diff, (got[k].double() - ref.double()).nan_to_num(0).abs().max().item())
    params = []
    torch.backends.cudnn.deterministic = True
    try:
        for feed in ("direct", "direct", "prefetched"):
            solver = Solver(config, make_loss(), copy.deepcopy(start_net), device=dev, display=0)
            batches = iter(host_batches)
            if feed == "prefetched":
                batches = iter(DevicePrefetcher(batches, device=dev))
            solver.solve(batches, max_iter=len(host_batches), log=lambda m: None)
            params.append({k: v.detach().clone() for k, v in solver.net.state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic = False

    def max_abs(a, b):
        return max((a[k] - b[k].to(dev)).abs().max().item() for k in a)

    return dict(batch_max_abs=batch_diff, max_abs_diff=max_abs(params[2], params[0]),
                plain_spread=max_abs(params[1], params[0]), moved=max_abs(params[0], start_net.state_dict()))


def native_decode_times(paths: list, rounds: int = 3) -> dict:
    """Every float-domain record of ``paths`` decoded by the native decoder
    (``data/native.py``) and by its numpy plain version
    (``records.decode_body``): equal (dtypes, shapes, values, NaN
    pattern); µs a record of each, the median of ``rounds`` passes over
    each file taken in turns (host clock)."""
    from flownet2_tpu_torch.data import FlowRecordReader, native
    from flownet2_tpu_torch.data.records import decode_body

    native.get_lib()  # built outside the timing
    out = {}
    for path in paths:
        reader = FlowRecordReader(path)
        bodies = [reader.body(i) for i in range(len(reader))]
        nan_px, keys = 0, set()
        for i, body in enumerate(bodies):
            got, ref = native.decode_record(body), decode_body(body, transport=False)
            check(got.keys() == ref.keys(), f"{path}[{i}]: keys {sorted(got)} vs {sorted(ref)}")
            for k in ref:
                check(got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
                      and np.array_equal(got[k], ref[k], equal_nan=True)
                      and np.array_equal(np.isnan(got[k]), np.isnan(ref[k])), f"{path}[{i}] {k}: native != numpy")
            nan_px += int(np.isnan(ref["flow"]).sum())
            keys |= set(ref)
        times = {"native": [], "numpy": []}
        fns = {"native": native.decode_record, "numpy": lambda b: decode_body(b, transport=False)}
        for r in range(rounds):
            for name in ("native", "numpy") if r % 2 == 0 else ("numpy", "native"):
                t0 = time.perf_counter()
                for body in bodies:
                    fns[name](body)
                times[name].append((time.perf_counter() - t0) / len(bodies) * 1e6)
        h, w = ref["img0"].shape[:2]
        out[os.path.basename(path)] = dict(records=len(bodies), size=f"{w}x{h}", keys=sorted(keys),
                                           nan_flow_values=nan_px,
                                           us=({k: statistics.median(v) for k, v in times.items()}))
    return out


def write_float_records(path: str, n: int, h: int, w: int, seed: int) -> None:
    """n records at hxw with a tenth of the flow values NaN (invalid) and,
    on every other record, an occlusion map."""
    from flownet2_tpu_torch.data import FlowRecordWriter

    rng = np.random.default_rng(seed)
    with FlowRecordWriter(path) as wr:
        for i in range(n):
            flow = rng.uniform(-40, 40, (h, w, 2)).astype(np.float32)
            flow[rng.random((h, w, 2)) < 0.1] = np.nan
            occ = rng.random((h, w)) < 0.2 if i % 2 == 0 else None
            wr.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                     flow, occ)


def print_feed_times(label: str, times: dict, card: str) -> dict:
    medians = {k: statistics.median(v) for k, v in times.items()}
    print(f"[times] train step {label} from .flowrec, ms a step by CUDA events between back-to-back steps, "
          f"median of {FEED_ROUNDS} rounds x {FEED_BLOCK} steps in turns [quartiles]: "
          + ", ".join(f"{k} {quartiles(v)}" for k, v in times.items())
          + f"; prefetched / resident {medians['prefetched'] / medians['resident']:.4f}, direct / resident "
          f"{medians['direct'] / medians['resident']:.4f}; resident and prefetched under sync debug mode 'error' "
          f"({card})")
    check(all(np.isfinite(v) and v > 0 for v in medians.values()), f"feed times {medians}")
    return medians


def phase_records(dev: torch.device, card: str) -> dict:
    """Training from packed records through ``cli.train``'s loader path
    (``BatchLoader`` -> ``DevicePrefetcher`` -> ``Solver.solve``): 16
    synthetic FlyingChairs pairs at 512x384 packed by cli.convert_dataset
    into a .flowrec; cli.train of FlowNetC on it, augmented to 448x320 b8
    (3 steps: two K1 launches, one correlation forward and one backward a
    step); one Solver step on the transport batch (uint8 images, int16
    flow) beside the same samples in float form (losses rtol 1e-6: the
    decode is exact); a disparity .flowrec of FlyingThings3D-size 960x540
    pairs and cli.train of DispNetC on it (3 steps at 768x384 b4, one 1-D
    forward and one backward a step); each CLI's batches staged by the
    prefetcher. Then for FlowNetC (center crops, as before the prefetcher)
    and DispNetC: the prefetched batches and the parameters after 3 steps
    against the direct feed (:func:`prefetch_equality`; FlowNetC
    augmented), and ms a step resident, fed directly and fed through the
    prefetcher, in turns (:func:`record_feed_times`); the native record
    decoder against numpy (:func:`native_decode_times`)."""
    from flownet2_tpu_torch.data import BatchLoader, DevicePrefetcher, FlowRecordReader, FlowRecordWriter
    from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss, make_flownet_augmenter
    from flownet2_tpu_torch.ops.correlation import (
        correlation_1d_backward_cuda,
        correlation_1d_cuda,
        correlation_backward_cuda,
        correlation_cuda,
    )
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import dispnet_c_loss, flownet_c_loss

    counters = (flow_warp_cuda, correlation_cuda, correlation_backward_cuda, correlation_1d_cuda,
                correlation_1d_backward_cuda)
    sched = FLOWNET_SCHEDULES["S_long"]
    config = SolverConfig(solver_type="adam", lr_policy=sched["policy"], base_lr=sched["base_lr"],
                          gamma=sched["gamma"], stepvalues=sched["stepvalues"], max_iter=sched["max_iter"],
                          momentum=0.9, momentum2=0.999)
    results, seconds, t0 = {}, {}, time.perf_counter()

    def part(label):
        nonlocal t0
        seconds[label] = time.perf_counter() - t0
        t0 = time.perf_counter()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_records_")
    try:
        nets = {"flownetc": _net("flownetc"), "dispnetc": _net("dispnetc")}
        chairs, rec = os.path.join(tmp, "chairs"), os.path.join(tmp, "chairs.flowrec")
        os.makedirs(chairs)
        write_chairs(chairs, 16, *CHAIRS_FRAME)
        cmd = [sys.executable, "-m", "flownet2_tpu_torch.cli.convert_dataset", rec, "--dataset", "flyingchairs",
               "--data-root", chairs]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0 and "wrote 16 records" in proc.stdout,
              f"convert_dataset exit {proc.returncode}: {proc.stdout[-500:]} {proc.stderr[-2000:]}")
        print(f"[records] cli.convert_dataset chairs.flowrec --dataset flyingchairs: 16 pairs at "
              f"{CHAIRS_FRAME[1]}x{CHAIRS_FRAME[0]}, {os.path.getsize(rec) / 1e6:.1f} MB")
        part("set-up")

        argv = ["--model", "flownetc", "--dataset", "flowrec", "--data-root", rec, "--batch", str(N), "--crop",
                f"{H}x{W}", "--max-iter", "3", "--display", "1", "--snapshot-dir", os.path.join(tmp, "snaps_c"),
                "--gpu", "0"]
        DevicePrefetcher.uploads = 0
        out, got = train_cli_in_process(argv, counters)
        staged = DevicePrefetcher.uploads
        check("Iteration 3, loss" in out and "augmented" in out
              and os.path.exists(os.path.join(tmp, "snaps_c", "iter_0000003.npz")), f"cli.train flownetc: {out[-1000:]}")
        check(got == (6, 3, 3, 0, 0), f"cli.train flownetc: launches (K1, corr, corr bwd, 1-D, 1-D bwd) {got}, "
              "expected (6, 3, 3, 0, 0): two K1 (the affine sample), one correlation forward and one backward a step")
        check(staged >= 3, f"cli.train flownetc: {staged} batches staged by DevicePrefetcher, expected >= 3")
        print(f"[records] cli.train --model flownetc --dataset flowrec --batch {N} --crop {H}x{W} (augmented from "
              f"{CHAIRS_FRAME[1]}x{CHAIRS_FRAME[0]}) --max-iter 3 --gpu 0: launches (K1, corr, corr bwd, 1-D, "
              f"1-D bwd) {got}; {staged} batches staged by DevicePrefetcher; {out.strip().splitlines()[-1]}")

        torch.backends.cudnn.deterministic = True
        losses, nbytes = {}, {}
        for transport in (True, False):
            loader = BatchLoader(FlowRecordReader(rec, transport=transport), N, crop=(H, W), shuffle_seed=None,
                                 num_threads=1, epochs=1)
            batch = next(iter(loader))
            check(batch["flow"].dtype == (np.int16 if transport else np.float32), f"flow dtype {batch['flow'].dtype}")
            nbytes[transport] = sum(v.nbytes for v in batch.values())
            net = copy.deepcopy(nets["flownetc"])
            losses[transport] = Solver(config, flownet_c_loss, net, device=dev).step(batch)[0].item()
        torch.backends.cudnn.deterministic = False
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        print(f"[records] one FlowNetC step on the card, transport batch (uint8, int16; {nbytes[True] / 1e6:.1f} MB "
              f"uploaded) vs its float form (native decode; {nbytes[False] / 1e6:.1f} MB): loss {losses[True]:.9g} "
              f"vs {losses[False]:.9g} (rel {rel:.3g}, limit 1e-6)")
        check(rel <= 1e-6, f"transport vs float loss rel {rel}")

        disp_rec = os.path.join(tmp, "disparity.flowrec")
        dh, dw = DISP_FRAME
        with FlowRecordWriter(disp_rec) as w:
            for i in range(2):
                b = stereo_batch(2, dh, dw, SEED + 40 + i)
                for j in range(2):
                    w.write(b["img0"][j].astype(np.uint8), b["img1"][j].astype(np.uint8), b["flow"][j])
        argv = ["--model", "dispnetc", "--dataset", "flowrec", "--data-root", disp_rec, "--no-augment", "--batch",
                str(DISP_TRAIN_N), "--crop", f"{DISP_TRAIN_H}x{DISP_TRAIN_W}", "--max-iter", "3", "--display", "1",
                "--snapshot-dir", os.path.join(tmp, "snaps_d"), "--gpu", "0"]
        DevicePrefetcher.uploads = 0
        out, got = train_cli_in_process(argv, counters)
        staged = DevicePrefetcher.uploads
        check("Iteration 3, loss" in out and os.path.exists(os.path.join(tmp, "snaps_d", "iter_0000003.npz")),
              f"cli.train dispnetc: {out[-1000:]}")
        check(got == (0, 0, 0, 3, 3), f"cli.train dispnetc: launches (K1, corr, corr bwd, 1-D, 1-D bwd) {got}, "
              "expected (0, 0, 0, 3, 3): one 1-D forward and one backward a step")
        check(staged >= 3, f"cli.train dispnetc: {staged} batches staged by DevicePrefetcher, expected >= 3")
        print(f"[records] disparity.flowrec: 4 pairs at {dw}x{dh}, {os.path.getsize(disp_rec) / 1e6:.1f} MB; "
              f"cli.train --model dispnetc --dataset flowrec --no-augment --batch {DISP_TRAIN_N} --crop "
              f"{DISP_TRAIN_H}x{DISP_TRAIN_W} --max-iter 3 --gpu 0: launches {got}; {staged} batches staged by "
              f"DevicePrefetcher; {out.strip().splitlines()[-1]}")
        part("cli.train and transport")

        chairs_ds, disp_ds = FlowRecordReader(rec, transport=True), FlowRecordReader(disp_rec, transport=True)
        equality = {
            "flownetc augmented": (nets["flownetc"], lambda: make_augmented_loss(flownet_c_loss, H, W, seed=SEED),
                                   BatchLoader(chairs_ds, N, shuffle_seed=SEED, num_threads=1,
                                               transform=make_flownet_augmenter(H, W))),
            "dispnetc": (nets["dispnetc"], lambda: dispnet_c_loss,
                         BatchLoader(disp_ds, DISP_TRAIN_N, crop=(DISP_TRAIN_H, DISP_TRAIN_W), shuffle_seed=SEED,
                                     num_threads=1)),
        }
        for label, (net, make_loss, loader) in equality.items():
            it = iter(loader)
            host = [next(it) for _ in range(3)]
            it.close()
            eq = prefetch_equality(dev, config, make_loss, net, host)
            results[f"{label} equality"] = eq
            print(f"[records] {label}: 3 batches through DevicePrefetcher vs the same host arrays uploaded directly: "
                  f"max abs {eq['batch_max_abs']:.3g}; parameters after Solver.solve over them, cuDNN deterministic, "
                  f"prefetched vs direct max abs {eq['max_abs_diff']:.3g} (two direct runs {eq['plain_spread']:.3g}; "
                  f"moved from the start {eq['moved']:.3g})")
            check(eq["batch_max_abs"] == 0, f"{label}: prefetched batches differ by {eq['batch_max_abs']}")
            check(eq["moved"] > 0, f"{label}: the steps did not move the parameters")
            check(eq["max_abs_diff"] <= eq["plain_spread"],
                  f"{label}: prefetched vs direct parameters differ by {eq['max_abs_diff']} "
                  f"(direct spread {eq['plain_spread']})")
        part("equality")

        feeds = {
            f"flownetc f32 {W}x{H} b{N} (center crops)": (
                nets["flownetc"], flownet_c_loss,
                lambda: BatchLoader(chairs_ds, N, crop=(H, W), shuffle_seed=SEED)),
            f"dispnetc f32 {DISP_TRAIN_W}x{DISP_TRAIN_H} b{DISP_TRAIN_N}": (
                nets["dispnetc"], dispnet_c_loss,
                lambda: BatchLoader(disp_ds, DISP_TRAIN_N, crop=(DISP_TRAIN_H, DISP_TRAIN_W), shuffle_seed=SEED)),
        }
        for label, (net, loss_fn, make_loader) in feeds.items():
            solver = Solver(config, loss_fn, copy.deepcopy(net), device=dev, display=0)
            results[label] = print_feed_times(label, record_feed_times(solver, make_loader, dev), card)
            del solver
        part("feed times")

        float_rec = os.path.join(tmp, "float.flowrec")
        write_float_records(float_rec, 16, *CHAIRS_FRAME, SEED + 50)
        decode = native_decode_times([float_rec, disp_rec])
        results["native decode"] = decode
        for name, d in decode.items():
            print(f"[records] {name}: {d['records']} float-domain records at {d['size']} ({', '.join(d['keys'])}; "
                  f"{d['nan_flow_values']} NaN flow values) decoded natively and by numpy: equal, the same NaN "
                  f"pattern; us a record (host clock, median of 3 passes in turns): native {d['us']['native']:.1f}, "
                  f"numpy {d['us']['numpy']:.1f} ({card})")
        part("native decode")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[records] parts (s, host clock): {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return results


def affine_theta(mats: torch.Tensor, src_h: int, src_w: int, out_h: int, out_w: int) -> torch.Tensor:
    """``F.affine_grid``'s (N, 2, 3) theta (align_corners=True) for crop ->
    source pixel affines (N, 6): normalized crop coordinates to normalized
    source coordinates."""
    t = mats.double()
    sx, sy = (out_w - 1) / 2, (out_h - 1) / 2  # crop pixel = (n + 1) * s
    kx, ky = 2 / (src_w - 1), 2 / (src_h - 1)  # source n = pixel * k - 1
    a = torch.stack([t[:, 0] * sx * kx, t[:, 2] * sy * kx, (t[:, 0] * sx + t[:, 2] * sy + t[:, 4]) * kx - 1], dim=1)
    b = torch.stack([t[:, 1] * sx * ky, t[:, 3] * sy * ky, (t[:, 1] * sx + t[:, 3] * sy + t[:, 5]) * ky - 1], dim=1)
    return torch.stack([a, b], dim=1).float()


def launch_counts(counters) -> tuple:
    return tuple(k.launches for k in counters)


def bf16_sample_check(batch: dict, dev: torch.device) -> None:
    """The JAX package's accelerator sample (``sample_dtype=torch.bfloat16``:
    bf16 images, the float32 position flow) of a batch's two frames on the
    card against the plain version's on the CPU. Both weight the taps in
    float32 and round the output to bfloat16 once, so they differ at most by
    one bfloat16 ulp below 1.0 (2^-8 on the [0, 1] scale) where the sums'
    order tips a rounding. K1's counter must count 2 launches, from 2 calls
    of ``flow_warp`` with a bfloat16 image and a float32 flow on the card."""
    from flownet2_tpu_torch.ops import augment as augment_ops
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda

    warp, seen = augment_ops.flow_warp, []

    def spy(image, flow, *args):
        seen.append((image.dtype, flow.dtype, image.device.type))
        return warp(image, flow, *args)

    def sample(device):
        return [augment_ops.apply_spatial_transform(
            torch.as_tensor(batch[f"img{i}"]).to(device).permute(0, 3, 1, 2).float() / 255.0,
            torch.as_tensor(batch[f"aug_mat{i}"]).to(device), H, W, sample_dtype=torch.bfloat16) for i in (0, 1)]

    t0 = time.perf_counter()
    flow_warp_cuda.launches = 0
    augment_ops.flow_warp = spy
    try:
        with torch.no_grad():
            got = sample(dev)
        torch.cuda.synchronize()
    finally:
        augment_ops.flow_warp = warp
    launches = flow_warp_cuda.launches
    ref = sample("cpu")
    err = max((g.cpu() - r).abs().max().item() for g, r in zip(got, ref))
    differ = sum(int((g.cpu() != r).sum()) for g, r in zip(got, ref)) / sum(r.numel() for r in ref)
    print(f"[augment] bf16 sample (sample_dtype=torch.bfloat16), {N} pairs {CHAIRS_FRAME[1]}x{CHAIRS_FRAME[0]} -> "
          f"{W}x{H}, card vs the plain version on the CPU: max abs err {err:.3g} on [0, 1] (limit 2^-8, one bf16 ulp "
          f"below 1.0), {differ:.3g} of the values differ; K1 launches {launches} from flow_warp calls with (image, "
          f"flow, device) {seen} ({time.perf_counter() - t0:.2f} s)")
    check(all(g.dtype == torch.float32 and g.shape == (N, 3, H, W) and torch.isfinite(g).all() for g in got),
          "bf16 sample: float32 finite crops")
    check(err <= 2.0 ** -8, f"bf16 sample, card vs CPU: {err}")
    check(launches == 2 and seen == [(torch.bfloat16, torch.float32, "cuda")] * 2,
          f"bf16 sample: K1 launches {launches} from flow_warp calls {seen}, expected 2 x (bfloat16, float32, cuda)")


def phase_augment(dev: torch.device, card: str, kernels: dict) -> dict:
    """The paper's augmented recipe: 16 synthetic 512x384 FlyingChairs-layout
    pairs to 448x320 b8. The augmented batch (noise 0) on the card against
    the port on the CPU (images 1e-3 on the 0-255 scale, flow 1e-4 px and
    the same NaN pattern); the batch's bfloat16 sample (the JAX package's
    accelerator route) on K1 against the CPU's, within one bf16 ulp
    (``bf16_sample_check``); the augmented FlowNetC step's launches, counted
    from 0 just before it (2 of K1, the affine sample of each frame; 0 of
    K2: the augmentation records no backward); the noise's statistics and
    its generator on the card; black, eigen and shadow on the card against
    the CPU (eigen 1e-5, black and shadow 1e-6); times by CUDA events of
    the augmentation alone, of K1 at its 8x3x384x512 canvas beside its bound and
    ``F.affine_grid`` + ``F.grid_sample`` at the crop (the library
    yardstick, timed: its border clamp is not the reference's w-1.05, so it
    is not compared), of the augmented FlowNetC step f32 and bf16 beside the
    unaugmented resident one (single steps in turns, and blocks of steps
    back to back); then cli.train in this process on a transport
    .flowrec: FlowNetC 3 steps with --recompute-mean 2 --write-augmented,
    and flownet2-sd-sdhom 2 steps (its Lpq loss at the first episode: the
    CLI sets no schedule and samples no black augmentation)."""
    import torch.nn.functional as F

    from flownet2_tpu_torch.data import BatchLoader, FlowRecordWriter, FlyingChairs
    from flownet2_tpu_torch.data.augment_pipeline import (
        apply_augmentation_device,
        make_augmented_loss,
        make_flownet_augmenter,
    )
    from flownet2_tpu_torch.ops.augment import (
        affine_position_flow,
        apply_black_augmentation,
        apply_chromatic_eigen_transform,
        apply_gaussian_noise,
        apply_shadow,
    )
    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import flownet_c_loss, with_compute_dtype

    counters = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)
    sh, sw = CHAIRS_FRAME
    sched = FLOWNET_SCHEDULES["S_long"]
    config = SolverConfig(solver_type="adam", lr_policy=sched["policy"], base_lr=sched["base_lr"],
                          gamma=sched["gamma"], stepvalues=sched["stepvalues"], max_iter=sched["max_iter"],
                          momentum=0.9, momentum2=0.999)
    timings = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_augment_")
    try:
        chairs = os.path.join(tmp, "chairs")
        os.makedirs(chairs)
        write_chairs(chairs, 2 * N, sh, sw)
        loader = iter(BatchLoader(FlyingChairs(chairs), N, shuffle_seed=SEED, num_threads=1,
                                  transform=make_flownet_augmenter(H, W)))
        batch = next(loader)
        check(batch["img0"].shape == (N, sh, sw, 3) and batch["aug_mat0"].shape == (N, 6),
              f"augmenting loader batch {batch['img0'].shape}")
        quiet = dict(batch, aug_noise=np.zeros(N, np.float32), flow=batch["flow"].copy())
        quiet["flow"][0, :, :, 0] = np.nan  # invalid ground truth: every crop of item 0 samples NaN in u
        quiet["flow"][1, sh // 3:sh // 2, sw // 3:sw // 2] = np.nan

        def augment_on(device):
            on = {k: torch.as_tensor(v).to(device) for k, v in quiet.items()}
            with torch.no_grad():
                return apply_augmentation_device(on, torch.Generator(device=device).manual_seed(SEED), H, W)

        for k in counters:
            k.launches = 0
        got = augment_on(dev)
        torch.cuda.synchronize()
        direct = launch_counts(counters)
        t0 = time.perf_counter()
        ref = augment_on("cpu")
        img_err = max((got[k].cpu() - ref[k]).abs().max().item() for k in ("img0", "img1"))
        flow, ref_flow = got["flow"].cpu(), ref["flow"]
        same_nan = torch.equal(flow.isnan(), ref_flow.isnan())
        flow_err = (flow - ref_flow)[~ref_flow.isnan()].abs().max().item()
        print(f"[augment] {N} pairs {sw}x{sh} -> {W}x{H}, noise 0, card vs the port on the CPU "
              f"({time.perf_counter() - t0:.1f} s on the CPU): images max abs err {img_err:.3g} on 0-255 (limit "
              f"1e-3), flow {flow_err:.3g} px (limit 1e-4), NaN pattern {'equal' if same_nan else 'DIFFERENT'} "
              f"({int(ref_flow.isnan().sum())} NaN values); launches (warp, warp bwd, corr, corr bwd) {direct}")
        check(got["img0"].shape == (N, 3, H, W) and got["flow"].shape == (N, 2, H, W), "augmented shapes")
        check(all(torch.isfinite(got[k]).all() for k in ("img0", "img1")), "augmented images not finite")
        check(img_err <= 1e-3, f"augmented images, card vs CPU: {img_err}")
        check(same_nan and bool(ref_flow.isnan().any()), "augmented flow: NaN pattern, card vs CPU")
        check(flow_err <= 1e-4, f"augmented flow, card vs CPU: {flow_err} px")
        check(direct == (2, 0, 0, 0), f"augmentation launches {direct}, expected (2, 0, 0, 0)")
        del got, ref
        bf16_sample_check(quiet, dev)

        solver = Solver(config, make_augmented_loss(flownet_c_loss, H, W, seed=SEED), _net("flownetc"), device=dev)
        for k in counters:
            k.launches = 0
        losses = [solver.step(next(loader))[0].item()]
        first_step = launch_counts(counters)
        losses += [solver.step(next(loader))[0].item() for _ in range(2)]
        got = launch_counts(counters)
        print(f"[augment] augmented flownetc f32 {W}x{H} b{N} from {sw}x{sh}: losses "
              f"{', '.join(f'{x:.6g}' for x in losses)}; launches (warp, warp bwd, corr, corr bwd) {first_step} in "
              f"the first step, {got} in 3")
        check(all(np.isfinite(losses)), "augmented step: loss not finite")
        check(first_step == (2, 0, 1, 1) and got == (6, 0, 3, 3),
              f"augmented step launches {first_step} / {got}, expected (2, 0, 1, 1) a step")
        kernels["flow_warp"]["augment_launches"] = first_step[0]
        kernels["flow_warp_backward"]["augment_launches"] = first_step[1]
        del solver

        grey = torch.full((N, 3, 64, 64), 0.5, device=dev)
        std = torch.full((N,), 0.05, device=dev)

        def noisy(seed, s=std):
            return apply_gaussian_noise(grey, s, torch.Generator(device=dev).manual_seed(seed))

        a = noisy(1)
        ratio = (a - grey).std().item() / 0.05
        loud = noisy(3, torch.ones(N, device=dev))
        print(f"[augment] noise on the card, std 0.05 on mid-grey {N}x3x64x64: measured/asked {ratio:.4f} (within "
              f"3%); seed 1 twice equal, seed 2 differs; std 1 clipped to [{loud.min().item()}, {loud.max().item()}]")
        check(abs(ratio - 1) < 0.03, f"noise std ratio {ratio}")
        check(torch.equal(a, noisy(1)) and not torch.equal(a, noisy(2)), "noise generator not reproducible")
        check(loud.min().item() == 0.0 and loud.max().item() == 1.0, "noise output not clipped to [0, 1]")

        # the transforms the default config leaves off, at the crop: 8-bit
        # pixel values, seeded coefficients, the card against the CPU
        rng = np.random.default_rng(SEED)
        unit = (rng.integers(0, 256, (N, 3, H, W)) / 256).astype(np.float32)
        gt = rng.normal(0, 4, (N, 2, H, W)).astype(np.float32)
        gt[0, :, H // 4:H // 2, W // 4:W // 2] = np.nan
        eig = {k: rng.uniform(0.7, 1.3, (N, 3)) for k in ("pow_nomean", "mult_nomean", "pow_withmean", "mult_withmean")}
        eig.update({k: rng.uniform(-0.1, 0.1, (N, 3)) for k in ("add_nomean", "add_withmean")})
        eig.update(lmult_pow=rng.uniform(0.8, 1.2, N), lmult_add=rng.uniform(-0.1, 0.1, N),
                   lmult_mult=rng.uniform(0.8, 1.2, N), col_angle=rng.uniform(-0.5, 0.5, N))
        ang = rng.uniform(-3, 3, N)
        shadow = (np.cos(ang), np.sin(ang), rng.uniform(-100, 100, N), rng.uniform(0.1, 0.5, N))
        black = (np.arange(N) % 4 == 1, np.where(np.arange(N) % 2 == 0, rng.uniform(0.05, 0.3, N), 0.0))

        def pixel_transforms(device):
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            img = t(unit)
            black_img, black_flow = apply_black_augmentation(img, t(gt), *map(t, black))
            return dict(eigen=apply_chromatic_eigen_transform(img, {k: t(v) for k, v in eig.items()}),
                        shadow=apply_shadow(img, *map(t, shadow)), black=black_img, black_flow=black_flow)

        on_card, on_cpu = pixel_transforms(dev), pixel_transforms("cpu")
        errs = {k: (on_card[k].cpu() - v).nan_to_num(0.0).abs().max().item() for k, v in on_cpu.items()}
        same_nan = all(torch.equal(on_card[k].cpu().isnan(), v.isnan()) for k, v in on_cpu.items())
        print(f"[augment] black, eigen, shadow on {N}x3x{H}x{W}, card vs CPU max abs err (limits eigen 1e-5, others "
              f"1e-6): {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; NaN pattern "
              f"{'equal' if same_nan else 'DIFFERENT'}")
        check(same_nan and bool(on_cpu["black_flow"].isnan().any()), "black flow: NaN pattern, card vs CPU")
        check(all(v <= (1e-5 if k == "eigen" else 1e-6) for k, v in errs.items()), f"pixel transforms: {errs}")
        del on_card, on_cpu

        resident = {k: torch.as_tensor(v, device=dev) for k, v in next(loader).items()}
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def augment():
            with torch.no_grad():
                apply_augmentation_device(resident, gen, H, W)

        aug_ms = cuda_ms(augment)
        img = (resident["img0"].permute(0, 3, 1, 2).float() / 255.0).contiguous()
        posflow = affine_position_flow(resident["aug_mat0"], sh, sw, sh, sw)
        k1_ms = cuda_ms(lambda: flow_warp_cuda(img, posflow))
        k1_bound = warp_bounds(N * sh * sw, torch.float32)[0]
        theta = affine_theta(resident["aug_mat0"], sh, sw, H, W)

        def library():
            grid = F.affine_grid(theta, (N, 3, H, W), align_corners=True)
            return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)

        lib_ms = cuda_ms(library)
        sample = flow_warp_cuda(img, posflow)[:, :, :H, :W]
        lib_diff = (library() - sample).abs().max().item()
        kernels["flow_warp"].update(augment_shape=f"{N}x3x{sh}x{sw} canvas, {N}x3x{H}x{W} crop", augment_ms=k1_ms,
                                    augment_bound_ms=k1_bound["bound_ms"], augment_library_ms=lib_ms)
        print(f"[times] augmentation alone (both frames, flow, chromatic, noise) {sw}x{sh} -> {W}x{H} b{N}: "
              f"{aug_ms:.4f} ms; K1 at its {N}x3x{sh}x{sw} canvas {k1_ms:.4f} ms, bound {k1_bound['bound_ms']:.4f} "
              f"ms ({k1_bound['bound_by']}); F.affine_grid + F.grid_sample (bilinear, border) at the crop "
              f"{lib_ms:.4f} ms (max abs difference to K1's sample {lib_diff:.3g}: the clamps differ) ({card})")
        timings["augment"] = dict(ms=aug_ms, k1_ms=k1_ms, library_ms=lib_ms)
        del img, posflow

        y0, x0 = (sh - H) // 2, (sw - W) // 2
        cropped = {k: resident[k][:, y0:y0 + H, x0:x0 + W].contiguous() for k in ("img0", "img1", "flow")}
        for label, loss_fn in (("f32", flownet_c_loss), ("bf16", with_compute_dtype(flownet_c_loss, torch.bfloat16))):
            aug_solver = Solver(config, make_augmented_loss(loss_fn, H, W, seed=SEED), _net("flownetc"), device=dev)
            plain_solver = Solver(config, loss_fn, _net("flownetc"), device=dev)

            def plain_block(k=16):
                for _ in range(k):
                    plain_solver.step(cropped)

            def aug_block(k=16):
                for _ in range(k):
                    aug_solver.step(resident)

            # single steps, each waited for; then blocks of 16 steps queued
            # back to back, as training runs them (one wait a block)
            plain, aug = interleaved_ms([lambda: plain_solver.step(cropped), lambda: aug_solver.step(resident)])
            diff = [a - p for a, p in zip(aug, plain)]
            plain_blocks, aug_blocks = interleaved_ms([plain_block, aug_block], rounds=4, warmup=1)
            per_step = [statistics.median(b) / 16 for b in (plain_blocks, aug_blocks)]
            timings[f"flownetc {label} augmented"] = dict(ms=aug, plain_ms=plain, block_ms=per_step)
            print(f"[times] train step flownetc {label} {W}x{H} b{N}, 25 single steps each in turns, median "
                  f"[quartiles] ms: augmented from {sw}x{sh} {quartiles(aug)}, unaugmented resident "
                  f"{quartiles(plain)}, paired difference {quartiles(diff)} "
                  f"({100 * statistics.median(diff) / statistics.median(plain):.1f}%); back to back, 4 blocks of 16 "
                  f"steps each in turns, median ms a step: augmented {per_step[1]:.3f}, unaugmented {per_step[0]:.3f} "
                  f"({100 * (per_step[1] / per_step[0] - 1):.1f}%) ({card})")
            del aug_solver, plain_solver

        rec = os.path.join(tmp, "chairs.flowrec")
        with FlowRecordWriter(rec) as w:
            for sample in FlyingChairs(chairs):
                w.write(sample["img0"].astype(np.uint8), sample["img1"].astype(np.uint8), sample["flow"])
        aug_dir = os.path.join(tmp, "augmented")
        runs = (  # label, arguments, steps, launches (warp, warp bwd, corr, corr bwd)
            ("flownetc", ["--model", "flownetc", "--recompute-mean", "2", "--write-augmented", aug_dir], 3,
             (12, 0, 3, 3)),
            ("flownet2-sd-sdhom", ["--model", "flownet2-sd", "--loss", "flownet2-sd-sdhom"], 2, (4, 0, 0, 0)),
        )
        for label, extra, steps, expected in runs:
            argv = [*extra, "--dataset", "flowrec", "--data-root", rec, "--batch", str(N), "--crop", f"{H}x{W}",
                    "--max-iter", str(steps), "--display", "1", "--snapshot-dir", os.path.join(tmp, f"snaps_{label}"),
                    "--gpu", "0"]
            t0 = time.perf_counter()
            out, got = train_cli_in_process(argv, counters)
            wall = time.perf_counter() - t0
            rates = [float(line.split("(")[-1].split()[0]) for line in out.splitlines() if line.startswith("Iteration")]
            check(f"Iteration {steps}, loss" in out and "augmented" in out, f"cli.train {label}: {out[-1000:]}")
            check(got == expected, f"cli.train {label}: launches {got}, expected {expected}")
            print(f"[augment] cli.train {' '.join(extra[:4])} --dataset flowrec (transport) --batch {N} --crop {H}x{W} "
                  f"--max-iter {steps} --display 1 --gpu 0: launches (warp, warp bwd, corr, corr bwd) {got}; ms a "
                  f"step by the log's rates {', '.join(f'{1e3 / r:.1f}' for r in rates)} (host clock, display and "
                  f"writes included), {wall:.1f} s in all with start-up; {out.strip().splitlines()[-1]}")
            timings[f"cli {label}"] = dict(step_ms=[1e3 / r for r in rates], seconds=wall)
        written = sorted(os.listdir(aug_dir))
        check(len(written) == 3 * 2 * N + 4 and "mean1.float3" in written and f"aug1_0000003({N - 1:03d}).ppm" in written,
              f"--write-augmented wrote {written[:6]}... ({len(written)} files)")
        print(f"[augment] --write-augmented: {len(written)} files ({written[0]} ... {written[-1]})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return timings

# cli.train iterations of the held-out check: on an H100 the held-out EPE
# fell to 0.52-0.61 of its start in 600 iterations and to 0.43-0.46 in
# 800-1000 (PERF.md section 6); the criterion is 0.6
TOOLS_TRAIN_ITERS = 1000
TOOLS_OVERFIT_ITERS = 200


def write_synth_chairs(root: str, n: int, h: int, w: int, seed: int) -> None:
    """n FlyingChairs-layout pairs (NNNNNNN-img0.ppm, -img1.ppm, -gt.flo) made
    by the port's synth_dataset at its easy settings."""
    from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
    from flownet2_tpu_torch.tools.synth_dataset import make_sample

    rng = np.random.default_rng(seed)
    for i in range(n):
        img0, img1, flow = make_sample(rng, h, w, n_layers=2, max_shift=5.0)
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), img0)
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"), img1)
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), flow)


def last_float(text: str, prefix: str, sep: str = "=") -> float:
    """The number after the last ``sep`` of the last line of ``text`` starting with ``prefix``."""
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return float(line.rsplit(sep, 1)[1].split()[0])


def phase_tools(dev: torch.device, card: str) -> dict:
    """The scoring, timing and convergence tools, at full width:

    1. held-out EPE: synthetic train (48) and held-out (8) splits at
       384x512 (synth_dataset's easy settings, max_shift 5, 2 layers);
       cli.train FlowNetC augmented at 320x448 b8 (Adam, S_short, 2e-4,
       seed 0), 2 K1, 1 correlation and 1 correlation backward launch a
       step; cli.test on the held-out split with the initial weights
       (``random`` is seed 0, the seed training started from) and with the
       final snapshot: trained < 0.6 x initial;
    2. cli.test --model flownet2 on the held-out split: 4 K1 and 1
       correlation launch a forward;
    3. tools.overfit on 8 synthetic pairs: the 1/4-resolution EPE ends below
       half its start; tools.overfit_cascade through all five stages, its
       .npz scored by cli.test;
    4. cli.time_cmd --breakdown: FlowNet2 at 448x320 b8 f32 and 1024x448
       b4 bf16 (4 K1, 1 correlation and 0 / 12 K3 launches a forward,
       counted over the timed forwards and apart over the walk's one; the
       table's count-weighted sum beside the whole program); --backward
       for flownet2 (4 K2 a step) and dispnetc at 768x384 b4 (one 1-D
       forward and backward a step, on a 1-channel disparity target);
    5. eval_parity: a float32 run dumps its .flo files, a bfloat16 run is
       compared with them; device_query;
    6. tools.diag.bf16_parity on the cascade's .npz: its three lines (f32
       and bf16 GT-EPE on 8 synthetic pairs, their divergence), 4 K1 and 1
       correlation launch a forward."""
    from flownet2_tpu_torch.cli import device_query, eval_parity, time_cmd
    from flownet2_tpu_torch.cli import test as test_cli
    from flownet2_tpu_torch.ops.correlation import (
        correlation_1d_backward_cuda,
        correlation_1d_cuda,
        correlation_backward_cuda,
        correlation_cuda,
    )
    from flownet2_tpu_torch.ops.head_conv import head_conv2d_cuda, head_deconv2d_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.tools import breakdown, overfit, overfit_cascade
    from flownet2_tpu_torch.tools.diag import bf16_parity
    from flownet2_tpu_torch.tools.synth_dataset import write_split

    counters = {"K1": flow_warp_cuda, "K2": flow_warp_backward_cuda, "corr": correlation_cuda,
                "corr bwd": correlation_backward_cuda, "K3 conv": head_conv2d_cuda, "K3 deconv": head_deconv2d_cuda,
                "1-D": correlation_1d_cuda, "1-D bwd": correlation_1d_backward_cuda}

    def reset():
        for k in counters.values():
            k.launches = 0

    def counted():
        got = {name: k.launches for name, k in counters.items()}
        got["K3"] = got.pop("K3 conv") + got.pop("K3 deconv")
        return {k: v for k, v in got.items() if v}

    results = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        # 1. held-out EPE before and after training
        t0 = time.perf_counter()
        train_rec, eval_rec = os.path.join(tmp, "train.flowrec"), os.path.join(tmp, "eval.flowrec")
        kw = dict(max_shift=5.0, n_layers=2, log=lambda *_: None)
        write_split(train_rec, 48, 11, *CHAIRS_FRAME, **kw)
        write_split(eval_rec, 8, 11 + 999_983, *CHAIRS_FRAME, **kw)
        print(f"[tools] synth_dataset: 48 train + 8 held-out samples at {CHAIRS_FRAME[1]}x{CHAIRS_FRAME[0]} "
              f"(max_shift 5, 2 layers) in {time.perf_counter() - t0:.1f} s")
        snaps = os.path.join(tmp, "snaps")
        iters = TOOLS_TRAIN_ITERS
        argv = ["--model", "flownetc", "--dataset", "flowrec", "--data-root", train_rec, "--batch", str(N), "--crop",
                f"{H}x{W}", "--max-iter", str(iters), "--schedule", "S_short", "--base-lr", "2e-4", "--seed", "0",
                "--display", str(iters // 4), "--snapshot-dir", snaps, "--snapshot-interval", "0", "--gpu", "0"]
        t0 = time.perf_counter()
        train_out, got = train_cli_in_process(argv, (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda,
                                                     correlation_backward_cuda))
        train_s = time.perf_counter() - t0
        check(got == (2 * iters, 0, iters, iters),
              f"cli.train flownetc: launches (K1, K2, corr, corr bwd) {got}, expected 2, 0, 1, 1 a step")
        losses = [line for line in train_out.splitlines() if line.startswith("Iteration")]
        print(f"[tools] cli.train --model flownetc (augmented) --crop {H}x{W} --batch {N} --max-iter {iters} "
              f"--schedule S_short --base-lr 2e-4 --seed 0: {train_s:.1f} s; launches (K1, K2, corr, corr bwd) {got}; "
              f"{'; '.join(losses)}")
        snapshot = os.path.join(snaps, f"iter_{iters:07d}.npz")
        epes = {}
        for label, weights in (("initial", "random"), ("trained", snapshot)):
            rc, out = main_in_process(test_cli.main, ["--weights", weights, "--model", "flownetc", "--dataset",
                                                      "flowrec", "--data-root", eval_rec, "--batch", "4", "--gpu", "0"])
            check(rc == 0, f"cli.test {label}: exit {rc}")
            epes[label] = last_float(out, "Loss:")
        ratio = epes["trained"] / epes["initial"]
        print(f"[tools] cli.test --model flownetc on the 8 held-out samples: EPE {epes['initial']:.4f} with the "
              f"initial weights, {epes['trained']:.4f} after {iters} iterations (ratio {ratio:.3f}, limit 0.6)")
        check(ratio < 0.6, f"held-out EPE {epes['trained']} not below 0.6 x the initial {epes['initial']}")
        results["held_out"] = dict(initial=epes["initial"], trained=epes["trained"], iters=iters, train_s=train_s)

        # 2. FlowNet2 scoring
        reset()
        rc, out = main_in_process(test_cli.main, ["--weights", "random", "--model", "flownet2", "--dataset", "flowrec",
                                                  "--data-root", eval_rec, "--batch", str(N), "--gpu", "0"])
        got = counted()
        check(rc == 0 and np.isfinite(last_float(out, "Loss:")), f"cli.test flownet2: exit {rc}: {out[-500:]}")
        check(got == {"K1": 4, "corr": 1}, f"cli.test flownet2, 1 batch: launches {got}, expected K1 4, corr 1")
        print(f"[tools] cli.test --model flownet2 (random) --batch {N}, 1 batch: {out.splitlines()[-1]}; "
              f"launches {got}")

        # 3. overfit and the stage-wise cascade
        pairs = os.path.join(tmp, "pairs")
        os.makedirs(pairs)
        write_synth_chairs(pairs, 8, *CHAIRS_FRAME, seed=SEED + 50)
        img0, img1, flow = overfit.load_examples(pairs, (H, W))
        # the overfit tool starts from init_params("flownets", seed=0)
        start = overfit.quarter_epe(_net("flownets", seed=0).to(dev), {
            k: torch.as_tensor(v, device=dev) for k, v in (("img0", img0), ("img1", img1), ("flow", flow))})
        t0 = time.perf_counter()
        rc, out = main_in_process(overfit.main, ["--data", pairs, "--iters", str(TOOLS_OVERFIT_ITERS), "--chunk", "50",
                                                 "--cosine", "--gpu", "0"])
        final = float(out.splitlines()[-1].split(";")[1].split()[0])
        print(f"[tools] tools.overfit --iters {TOOLS_OVERFIT_ITERS} --cosine on 8 synthetic pairs ({W}x{H}): "
              f"{time.perf_counter() - t0:.1f} s, exit {rc}; 1/4-resolution EPE {start:.4f} at the start, "
              f"{final:.4f} at the end (limit half the start); {out.splitlines()[-1]}")
        check(final < 0.5 * start, f"overfit: 1/4-resolution EPE {final} not below half of {start}")
        results["overfit"] = dict(start=start, final=final)

        t0 = time.perf_counter()
        casc = os.path.join(tmp, "cascade")
        rc, out = main_in_process(overfit_cascade.main, ["--data", pairs, "--iters", "10", "--chunk", "10", "--out",
                                                         casc, "--gpu", "0"])
        with open(os.path.join(casc, "results.json")) as f:
            casc_results = json.load(f)
        check(list(casc_results["stages"]) == ["c", "s1", "s2", "sd", "fusion"], f"cascade stages {casc_results}")
        rc_t, scored = main_in_process(test_cli.main, ["--weights", os.path.join(casc, "flownet2_staged.npz"),
                                                       "--model", "flownet2", "--dataset", "flowrec", "--data-root",
                                                       eval_rec, "--batch", str(N), "--gpu", "0"])
        check(rc_t == 0 and np.isfinite(last_float(scored, "Loss:")), f"cli.test on the cascade .npz: {scored[-500:]}")
        print(f"[tools] tools.overfit_cascade --iters 10 (each of c, s1, s2, sd, fusion): {time.perf_counter() - t0:.1f}"
              f" s, exit {rc}; cascade EPE {casc_results['init_epe']:.4f} at init, after each stage "
              f"{', '.join(f'{k} {v['cascade_epe']:.4f}' for k, v in casc_results['stages'].items())}; its .npz "
              f"through cli.test on the held-out split: {scored.splitlines()[-1]}")

        # 4. timing: counted launches a forward, then the per-stage tables
        runs = [  # label, arguments, launches per call of the timed function, calls
            ("448x320 b8 f32", ["--model", "flownet2", "--height", str(H), "--width", str(W), "--batch", str(N)],
             {"K1": 4, "corr": 1}),
            ("1024x448 b4 bf16", ["--model", "flownet2", "--height", str(SINTEL_H), "--width", str(SINTEL_W),
                                  "--batch", str(SINTEL_N), "--dtype", "bfloat16"], {"K1": 4, "corr": 1, "K3": 12}),
        ]
        iterations = 10
        walk = breakdown.walk_stages
        for label, argv, per_call in runs:
            # one --breakdown run: the launches of the first call, the 2
            # warm-ups and the timed forwards are read as the walk starts,
            # and the walk's own forward is counted apart
            seen = {}

            def counting_walk(*a, **kw):
                seen["timed"] = counted()
                reset()
                stages = walk(*a, **kw)
                seen["walk"] = counted()
                return stages

            reset()
            breakdown.walk_stages = counting_walk
            try:
                rc, out = main_in_process(time_cmd.main, argv + ["--iterations", str(iterations), "--breakdown",
                                                                 "--gpu", "0"])
            finally:
                breakdown.walk_stages = walk
            calls = iterations + 3  # the first call, 2 warm-ups, the timed ones
            check(rc == 0 and "vs whole-program above" in out, f"time_cmd --breakdown {label}: {out[-800:]}")
            check(seen.get("timed") == {k: v * calls for k, v in per_call.items()} and seen.get("walk") == per_call,
                  f"time_cmd {label}: launches {seen} in {calls} forwards and the walk's one, expected {per_call} a "
                  f"forward")
            total = last_float(out, "sum (count-weighted)", sep=")")
            fwd_ms = last_float(out, "forward:", sep=":")
            print(f"[tools] time_cmd {' '.join(argv)} --iterations {iterations} --breakdown: {out.splitlines()[0]}; "
                  f"launches in {calls} forwards {seen['timed']}, in the walk's forward {seen['walk']} ({per_call} a "
                  f"forward) ({card})")
            print(f"[tools] the per-stage table ({label}; stage times alone, CUDA events, 3 warm-ups, 10 runs):")
            for line in out.splitlines()[1:]:
                print(f"[tools]   {line}")
            print(f"[tools]   table sum {total:.3f} ms beside the whole program's {fwd_ms:.3f} ms "
                  f"({100 * (total / fwd_ms - 1):+.1f}%) ({card})")
            results[f"time {label}"] = dict(forward_ms=fwd_ms, table_sum_ms=total)

        backward_runs = [
            ("flownet2 448x320 b8", ["--model", "flownet2", "--height", str(H), "--width", str(W), "--batch", str(N)],
             {"K1": 8, "K2": 4, "corr": 2, "corr bwd": 1}),
            ("dispnetc 768x384 b4", ["--model", "dispnetc", "--height", str(DISP_TRAIN_H), "--width",
                                     str(DISP_TRAIN_W), "--batch", str(DISP_TRAIN_N)], {"1-D": 2, "1-D bwd": 1}),
        ]
        for label, argv, per_pair in backward_runs:
            reset()
            rc, out = main_in_process(time_cmd.main, argv + ["--iterations", str(iterations), "--backward", "--gpu", "0"])
            got = counted()
            calls = iterations + 3
            # a forward call and a forward+backward call each: the forward's kernels twice, the backward's once
            check(rc == 0 and got == {k: v * calls for k, v in per_pair.items()},
                  f"time_cmd --backward {label}: launches {got}, expected {per_pair} per forward and fwd+bwd pair")
            print(f"[tools] time_cmd {' '.join(argv)} --iterations {iterations} --backward: "
                  f"{'; '.join(out.splitlines()[:2])}; launches {got} ({card})")
            results[f"time backward {label}"] = out.splitlines()[:2]

        # 5. eval_parity: float32 dumps, bfloat16 compared with them; device_query
        lst, dumped = os.path.join(tmp, "pairs.txt"), os.path.join(tmp, "f32")
        with open(lst, "w") as f:
            f.writelines(f"{pairs}/{i:07d}-img0.ppm {pairs}/{i:07d}-img1.ppm {pairs}/{i:07d}-gt.flo\n" for i in range(8))
        weights = os.path.join(casc, "flownet2_staged.npz")
        rc, out = main_in_process(eval_parity.main, ["--model", "flownet2", "--weights", weights, "--list", lst,
                                                     "--out-dir", dumped, "--gpu", "0"])
        f32 = json.loads(out.splitlines()[-1])
        with open(lst + ".f32", "w") as f:
            f.writelines(f"{pairs}/{i:07d}-img0.ppm {pairs}/{i:07d}-img1.ppm {dumped}/{i:07d}-gt.flo\n" for i in range(8))
        rc2, out = main_in_process(eval_parity.main, ["--model", "flownet2", "--weights", weights, "--list",
                                                      lst + ".f32", "--dtype", "bfloat16", "--gpu", "0"])
        bf16 = json.loads(out.splitlines()[-1])
        check(rc == rc2 == 0 and f32["pairs"] == bf16["pairs"] == 8, f"eval_parity: {f32}, {bf16}")
        print(f"[tools] eval_parity --model flownet2 (the cascade .npz) on the 8 pairs at {CHAIRS_FRAME[1]}x"
              f"{CHAIRS_FRAME[0]}: f32 against the ground truth {json.dumps(f32)}; bf16 against the f32 .flo files "
              f"{json.dumps(bf16)}")
        rc, out = main_in_process(device_query.main, [])
        check(rc == 0 and torch.cuda.get_device_name(0) in out, f"device_query: {out}")
        print("[tools] device_query: " + " | ".join(out.strip().splitlines()))

        # 6. the bf16 parity tool on the cascade's .npz
        reset()
        rc, out = main_in_process(bf16_parity.main, ["--weights", weights, "--synth", "--size", f"{H}x{W}",
                                                     "--gpu", "0"])
        lines = out.strip().splitlines()
        epes = [last_float(out, "f32  GT-EPE", sep=":"), float(lines[1].split(":")[1].split()[0])]
        check(rc == 0 and len(lines) == 3 and all(np.isfinite(epes)) and counted() == {"K1": 8, "corr": 2},
              f"bf16_parity: exit {rc}, launches {counted()}: {out[-600:]}")
        print(f"[tools] tools.diag.bf16_parity --model flownet2 (the cascade .npz) --synth --size {H}x{W} (8 pairs), "
              f"launches {counted()} ({card}):")
        for line in lines:
            print(f"[tools]   {line}")
        results["bf16_parity"] = dict(f32_epe=epes[0], bf16_epe=epes[1], lines=lines)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


# [dp]: FlowNetC at 448x320, global batch 8, float32, Adam, augmented from
# 512x384 sources (noise 0 where ranks are compared with one process)
DP_STEPS = 3


def dp_loaders(chairs: str, shard: tuple[int, int], noise: bool):
    """The keyed loader of the global batch of N over ``chairs``: this
    rank's rows of each augmented batch (``shard`` (rank, world))."""
    from flownet2_tpu_torch.data import BatchLoader, FlyingChairs
    from flownet2_tpu_torch.data.augment_pipeline import FlowNetAugConfig, make_flownet_augmenter
    from flownet2_tpu_torch.ops.augment import EffectAugSpec

    config = FlowNetAugConfig() if noise else FlowNetAugConfig(effect=EffectAugSpec())
    return iter(BatchLoader(FlyingChairs(chairs), N, shuffle_seed=SEED, shard=shard,
                            transform=make_flownet_augmenter(H, W, config)))


def dp_solver(loss_key: str, rank: int, group=None, dev=None, iter_size: int = 1):
    """A Solver of ``loss_key`` (flownetc, or flownet2-s1 on a FlowNet2)
    with the augmented objective, seeded weights, Adam at S_long's rate."""
    from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import LOSSES, trainable_module

    net = _net("flownet2" if loss_key == "flownet2-s1" else "flownetc")
    loss = make_augmented_loss(LOSSES[loss_key], H, W, seed=SEED, rank=rank)
    config = SolverConfig(solver_type="adam", lr_policy="fixed", base_lr=FLOWNET_SCHEDULES["S_long"]["base_lr"],
                          momentum=0.9, momentum2=0.999, iter_size=iter_size)
    return Solver(config, loss, net, device=dev, group=group, trainable=trainable_module(net, loss_key))


def dp_run(solver, loader, steps: int, counters, micro: int = 1) -> dict:
    """``steps`` steps from ``loader`` (each batch cut into ``micro``
    micro-batches of consecutive rows, for ``iter_size`` ``micro``):
    losses, the launches of ``counters`` counted from 0 around the steps,
    ms a step by the host clock after the first, the trainable gradients
    of the first step and the trainable parameters after the last."""
    for k in counters:
        k.launches = 0
    losses, t0, grads = [], None, None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        batch = next(loader)
        if micro > 1:
            batch = {k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:]) for k, v in batch.items()}
        losses.append(solver.step(batch)[0].item())
        if i == 0:
            grads = {k: p.grad.cpu().numpy().copy() for k, p in solver.net.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - 1) * 1e3 if steps > 1 else float("nan")
    params = {k: p.detach().cpu().numpy().copy() for k, p in solver.net.named_parameters() if p.requires_grad}
    return dict(losses=losses, launches=launch_counts(counters), ms=ms, grads=grads, params=params)


def _dp_rank(group, chairs: str) -> dict:
    """A rank of the 2-process gloo run on one card: FlowNetC for DP_STEPS
    steps and one flownet2-s1 step on this rank's rows, noise 0."""
    import hashlib

    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda

    counters = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for key, steps in (("flownetc", DP_STEPS), ("flownet2-s1", 1)):
        run = dp_run(dp_solver(key, group.rank, group), dp_loaders(chairs, (group.rank, group.world), False), steps,
                     counters)
        digest = hashlib.sha1(b"".join(run["params"][k].tobytes() for k in sorted(run["params"]))).hexdigest()
        if not group.is_main:
            run = dict(run, grads=None, params=None)
        out[key] = dict(run, digest=digest)
    return out


def rel_errors(got: dict, ref: dict, start: dict | None = None) -> dict:
    """Relative L2 of ``got`` against ``ref`` (of their updates from
    ``start``, where given): over all tensors together and for the median
    tensor."""
    per, diff, norm = [], 0.0, 0.0
    for k, r in ref.items():
        want, have = (r, got[k]) if start is None else (r - start[k], got[k] - start[k])
        d, n = float(np.sum((have - want) ** 2)), float(np.sum(want ** 2))
        per.append((d / n) ** 0.5 if n else 0.0)
        diff, norm = diff + d, norm + n
    return {"all": (diff / norm) ** 0.5, "median": statistics.median(per), "tensors": len(per)}


def phase_dp(dev: torch.device, card: str) -> dict:
    """Data-parallel training (``parallel``; Solver's group; cli.train --gpu)
    at full width on the one card of this host:

    1. world size 1 over NCCL against the plain Solver: DP_STEPS augmented
       FlowNetC steps, cuDNN deterministic; parameters equal (max abs 0,
       or within the spread of two plain runs, both printed) and the same
       launches a step; the flat FlowNetC gradient all-reduce timed at
       world 1 by CUDA events, and the group step beside the plain one
       (single steps in turns);
    2. 2 ranks over gloo on cuda:0 (two processes sharing the card, 4 pairs
       each) against one process on the global batch of 8, noise 0, cuDNN
       deterministic, for DP_STEPS FlowNetC steps and one flownet2-s1
       step: loss rtol 1e-4
       and the first step's gradients (relative L2 of all tensors and of
       the median tensor within 1e-3) against b8; the updates (the same
       limits) against one process at iter_size 2 on the ranks' halves,
       since Adam turns b8's rounding against 2 x b4 into about 1% of an
       update (printed beside); each rank's launches equal the plain
       step's; ms a step (two processes on one card: not a multi-card
       number);
    3. cli.train --gpu all trains on the one card; --gpu 0,1 is refused
       ("1 present")."""
    import torch.distributed as dist

    from flownet2_tpu_torch.cli.train import main as train_main
    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.parallel import init_group, spawn
    from flownet2_tpu_torch.parallel.mesh import free_address

    counters = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)
    results, t_phase = {}, time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    deterministic = torch.backends.cudnn.deterministic
    try:
        chairs = os.path.join(tmp, "chairs")
        os.makedirs(chairs)
        write_chairs(chairs, 2 * N, *CHAIRS_FRAME)

        # 1. world 1 over NCCL against the plain Solver
        torch.backends.cudnn.deterministic = True
        plain = [dp_run(dp_solver("flownetc", 0, dev=dev), dp_loaders(chairs, (0, 1), True), DP_STEPS, counters)
                 for _ in range(2)]
        group = init_group(0, 1, dev, free_address(), backend="nccl")
        try:
            grouped = dp_run(dp_solver("flownetc", 0, group), dp_loaders(chairs, (0, 1), True), DP_STEPS, counters)
            flat = torch.randn(sum(v.size for v in grouped["params"].values()), device=dev)
            allreduce_ms = cuda_ms(lambda: dist.all_reduce(flat), warmup=3, runs=20)
            # the world-1 group step beside the plain one, single steps in turns, cuDNN's default algorithms
            torch.backends.cudnn.deterministic = deterministic
            resident = {k: torch.as_tensor(v, device=dev) for k, v in next(dp_loaders(chairs, (0, 1), True)).items()}
            solvers = [dp_solver("flownetc", 0, dev=dev), dp_solver("flownetc", 0, group)]
            step_ms = interleaved_ms([lambda sv=sv: sv.step(resident) for sv in solvers], rounds=20)
            del solvers, resident
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = True
        paired = [g - p for p, g in zip(*step_ms)]
        spread = max(float(np.abs(plain[0]["params"][k] - plain[1]["params"][k]).max()) for k in plain[0]["params"])
        diff = max(float(np.abs(grouped["params"][k] - plain[0]["params"][k]).max()) for k in plain[0]["params"])
        print(f"[dp] world 1 over NCCL against the plain Solver, {DP_STEPS} augmented FlowNetC steps {W}x{H} b{N} "
              f"f32 Adam, cuDNN deterministic: parameters max abs diff {diff:.3g} (two plain runs {spread:.3g}); "
              f"losses {grouped['losses']} vs {plain[0]['losses']}; launches (warp, warp bwd, corr, corr bwd) in "
              f"{DP_STEPS} steps {grouped['launches']} vs plain {plain[0]['launches']}; ms a step {grouped['ms']:.3f} "
              f"vs plain {plain[0]['ms']:.3f} (host clock) ({card})")
        check(diff <= spread, f"world 1 over NCCL: parameters differ by {diff} from the plain Solver's "
                              f"(spread {spread})")
        check(grouped["launches"] == plain[0]["launches"] and grouped["launches"][2] == DP_STEPS,
              f"world 1 launches {grouped['launches']} vs plain {plain[0]['launches']}")
        print(f"[dp] all_reduce of the flat FlowNetC gradient ({flat.numel()} float32, {flat.numel() * 4 / 1e6:.1f} MB) "
              f"at world 1 over NCCL: {allreduce_ms:.4f} ms (CUDA events, median of 20) ({card})")
        print(f"[times] train step flownetc f32 {W}x{H} b{N} augmented, 20 single steps each in turns on a resident "
              f"batch, median [quartiles] ms: plain Solver {quartiles(step_ms[0])}, world-1 NCCL group "
              f"{quartiles(step_ms[1])}, paired difference {quartiles(paired)} "
              f"({100 * statistics.median(paired) / statistics.median(step_ms[0]):.1f}%) ({card})")
        results["world1"] = dict(max_abs_diff=diff, plain_spread=spread, allreduce_ms=allreduce_ms,
                                 launches=grouped["launches"], plain_ms=statistics.median(step_ms[0]),
                                 group_ms=statistics.median(step_ms[1]), paired_ms=statistics.median(paired))
        del plain, grouped, flat

        # 2. two ranks over gloo on cuda:0 against one process on the global
        # batch: at b8 (the gradients), and at iter_size 2 on the ranks'
        # halves (the updates; Adam turns the batch-size rounding of b8
        # against 2 x b4 into about 1% of the update, in one process too),
        # all with cuDNN's deterministic algorithms
        t0 = time.perf_counter()
        ranks = spawn(_dp_rank, [dev, dev], chairs, backend="gloo", join_timeout=600)
        spawn_s = time.perf_counter() - t0
        for key, steps in (("flownetc", DP_STEPS), ("flownet2-s1", 1)):
            refs = {}
            for micro in (1, 2):
                solver = dp_solver(key, 0, dev=dev, iter_size=micro)
                start = {k: p.detach().cpu().numpy().copy() for k, p in solver.net.named_parameters()
                         if p.requires_grad}
                refs[micro] = dp_run(solver, dp_loaders(chairs, (0, 1), False), steps, counters, micro=micro)
                del solver
            got = ranks[0][key]
            check(ranks[1][key]["digest"] == got["digest"], f"{key}: the two ranks' parameters differ")
            rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], refs[1]["losses"]))
            g8 = rel_errors(got["grads"], refs[1]["grads"])
            u2 = rel_errors(got["params"], refs[2]["params"], start)
            u8 = rel_errors(got["params"], refs[1]["params"], start)
            spread = rel_errors(refs[2]["params"], refs[1]["params"], start)
            print(f"[dp] 2 ranks over gloo on cuda:0 (4 pairs each) against one process, {key}, {steps} step(s), "
                  f"noise 0: losses {got['losses']} vs b{N} {refs[1]['losses']} (rel {rel:.3g}, limit 1e-4); first "
                  f"step's gradients against b{N}, {g8['tensors']} tensors: relative L2 of all {g8['all']:.3g}, "
                  f"median tensor {g8['median']:.3g} (limits 1e-3); updates after {steps} step(s) against one process "
                  f"at iter_size 2 on the same halves: all {u2['all']:.3g}, median {u2['median']:.3g} (limits 1e-3); "
                  f"against b{N}: all {u8['all']:.3g}, median {u8['median']:.3g}, beside iter_size 2 against b{N} in "
                  f"one process: all {spread['all']:.3g}, median {spread['median']:.3g}; launches (warp, warp bwd, "
                  f"corr, corr bwd) rank 0 {got['launches']}, rank 1 {ranks[1][key]['launches']}, one process "
                  f"{refs[1]['launches']}")
            check(rel <= 1e-4, f"{key}: 2-rank loss rel err {rel}")
            check(g8["all"] <= 1e-3 and g8["median"] <= 1e-3, f"{key}: 2-rank gradients against b{N} {g8}")
            check(u2["all"] <= 1e-3 and u2["median"] <= 1e-3, f"{key}: 2-rank updates against iter_size 2 {u2}")
            check(got["launches"] == ranks[1][key]["launches"] == refs[1]["launches"] and refs[1]["launches"][0] > 0,
                  f"{key}: launches rank 0 {got['launches']}, rank 1 {ranks[1][key]['launches']}, one process "
                  f"{refs[1]['launches']}")
            results[key] = dict(loss_rel=rel, grad_rel_l2=g8["all"], grad_median=g8["median"],
                                update_vs_iter2=u2["all"], update_vs_b8=u8["all"], iter2_vs_b8=spread["all"],
                                ms=got["ms"], one_process_ms=refs[1]["ms"], launches=got["launches"])
            del refs
        print(f"[dp] 2-rank gloo FlowNetC step on one card (two processes sharing cuda:0, the gradients through the "
              f"host; not a multi-card number): {ranks[0]['flownetc']['ms']:.3f} ms a step on rank 0 (host clock, "
              f"steps 2-{DP_STEPS}) vs {results['flownetc']['one_process_ms']:.3f} one process at b{N}; the "
              f"spawn, both ranks' runs included: {spawn_s:.1f} s ({card})")
        del ranks

        # 3. the CLI: --gpu all on this host's one card; --gpu 0,1 refused
        argv = ["--model", "flownetc", "--data-root", chairs, "--batch", str(N), "--crop", f"{H}x{W}", "--max-iter",
                "3", "--display", "1", "--snapshot-dir", "", "--gpu", "all"]
        out, got = train_cli_in_process(argv, counters)
        check("on cuda:0" in out and "Iteration 3, loss" in out and got == (6, 0, 3, 3),
              f"cli.train --gpu all: launches {got}: {out[-600:]}")
        try:
            main_in_process(train_main, argv[:-1] + ["0,1"])
            refused = None
        except SystemExit as e:
            refused = str(e)
        check(refused is not None and "1 present" in refused, f"cli.train --gpu 0,1: {refused}")
        print(f"[dp] cli.train --gpu all (this host's {torch.cuda.device_count()} card): 3 steps, launches (warp, warp "
              f"bwd, corr, corr bwd) {got}, {out.splitlines()[0]}; --gpu 0,1 refused: {refused}")
        print(f"[dp] the phase: {time.perf_counter() - t_phase:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    return results


CACHE_SLAB, CACHE_SLABS, CACHE_FILE_SAMPLES = 16, 4, 16
CACHE_TIMED_STEPS = 32
# spin cycles the card sleeps before each chunk of the refresh-hazard run
# (about 0.4 s at the H100's clock, more than the host takes to queue a
# chunk), so that the card falls chunks behind the host, and slabs are
# swapped and dropped before the card reads them
HAZARD_SLEEP_CYCLES = 700_000_000


def busy_ms(prof) -> float:
    """Length of the union of the device's kernel, copy and memset intervals
    in a profile, in ms (user annotations left out, as
    ``scripts/profile_slice.py::busy_us`` does)."""
    from torch.autograd import DeviceType

    ivs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    total, start, end = 0.0, None, None
    for s, e in ivs:
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def step_times(fn, calls: int, warmup: int, strict: bool = False) -> list[float]:
    """ms of each of ``calls`` back-to-back calls of ``fn`` by CUDA events
    recorded between them (nothing waits in between), after ``warmup``.
    ``strict``: the timed calls run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a call that waits for
    the card raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        events[0].record()
        for e in events[1:]:
            fn()
            e.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def idle_share(fn, calls: int) -> float:
    """1 - device busy / wall over ``calls`` calls of ``fn`` under
    ``torch.profiler`` (the device's activity only; wall by the host clock,
    from a drained queue to a drained queue)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return 1 - busy_ms(prof) / wall


def id_samples(start: int = 0):
    """An endless stream of 512x384 transport samples, each filled with its
    own id: images id % 251, flow id % 32000 in both channels, and ``sid``."""
    sh, sw = CHAIRS_FRAME
    i = start
    while True:
        img = np.full((sh, sw, 3), i % 251, np.uint8)
        yield {"img0": img, "img1": img, "flow": np.full((sh, sw, 2), i % 32000, np.int16), "sid": np.int32(i)}
        i += 1


class CacheRig:
    """What the [cache] parts share: the r5 recipe's FlowNetS step (Adam at
    2e-4, S_short, augmented 448x320 b8 crops of 512x384 samples), its
    seeded starting net, and a synthetic transport .flowrec."""

    def __init__(self, dev: torch.device, tmp: str):
        from flownet2_tpu_torch.data import FlowRecordReader, FlowRecordWriter
        from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss
        from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, SolverConfig
        from flownet2_tpu_torch.train.objectives import flownet_s_loss

        sched = FLOWNET_SCHEDULES["S_short"]
        self.dev = dev
        self.config = SolverConfig(solver_type="adam", lr_policy=sched["policy"], base_lr=2e-4, gamma=sched["gamma"],
                                   stepvalues=sched["stepvalues"], max_iter=sched["max_iter"], momentum=0.9,
                                   momentum2=0.999)
        self.aug_loss = make_augmented_loss(flownet_s_loss, H, W, seed=SEED)
        self.start_net = _net("flownets")
        sh, sw = CHAIRS_FRAME
        rec = os.path.join(tmp, "chairs.flowrec")
        rng = np.random.default_rng(SEED + 7)
        ys, xs = np.mgrid[0:sh, 0:sw].astype(np.float32)
        with FlowRecordWriter(rec) as w:
            for _ in range(CACHE_FILE_SAMPLES):  # frame 1: frame 0 moved by a whole-pixel shift, the flow
                frame = random_texture(rng)(xs, ys).astype(np.uint8)
                dx, dy = (int(v) for v in rng.integers(-6, 7, 2))
                w.write(frame, np.roll(frame, (dy, dx), axis=(0, 1)),
                        np.broadcast_to(np.float32([dx, dy]), (sh, sw, 2)).copy())
        self.dataset = FlowRecordReader(rec, transport=True)

    def aug_sampler(self, rng, n, quiet=False):
        """The CLI's sampler; ``quiet``: noise 0."""
        from flownet2_tpu_torch.data.augment_pipeline import FlowNetAugConfig, sample_aug_arrays

        arrays = sample_aug_arrays(FlowNetAugConfig(), rng, n, *CHAIRS_FRAME, H, W)
        if quiet:
            arrays["aug_noise"] = np.zeros_like(arrays["aug_noise"])
        return arrays

    def solver(self, loss_fn):
        from flownet2_tpu_torch.train import Solver

        return Solver(self.config, loss_fn, copy.deepcopy(self.start_net), device=self.dev, display=0)


def cache_equality(rig: CacheRig, kernels: dict) -> dict:
    """4 steps through ``solve_cached`` at K = 4 from a cache of 2 x 16
    samples (no refresh, noise 0) against the same 4 batches gathered on the
    host through ``Solver.step``, cuDNN deterministic: parameters max abs 0,
    or within the spread of two plain runs (both printed); K1's launches in
    the cached steps, counted from 0 (2 a step)."""
    from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss
    from flownet2_tpu_torch.data.device_cache import CacheChunks, DeviceSampleCache, cycle_dataset, make_cache_gather_loss
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.train.objectives import flownet_s_loss

    dev = rig.dev
    torch.backends.cudnn.deterministic = True
    try:
        cache = DeviceSampleCache(cycle_dataset(rig.dataset, seed=SEED), slab_samples=CACHE_SLAB, n_slabs=2,
                                  refresh=False, device=dev)
        slabs, bank = next(iter(CacheChunks(cache, N, 4, seed=SEED,
                                            aug_sampler=lambda r, n: rig.aug_sampler(r, n, quiet=True))))
        host_slabs = [{k: v.cpu().numpy() for k, v in s.items()} for s in slabs]
        merged = {k: np.concatenate([s[k] for s in host_slabs]) for k in host_slabs[0]}
        batches = [{**{k: v[bank["cache_idx"][i]] for k, v in merged.items()},
                    **{k: v[i] for k, v in bank.items() if k != "cache_idx"}} for i in range(4)]
        cached = rig.solver(make_cache_gather_loss(rig.aug_loss))
        for k in (flow_warp_cuda, flow_warp_backward_cuda):
            k.launches = 0
        cached.solve_cached(iter([(slabs, bank)]), max_iter=4, log=lambda m: None)
        torch.cuda.synchronize()
        launches = (flow_warp_cuda.launches, flow_warp_backward_cuda.launches)
        plain_params = []
        for _ in range(2):
            plain = rig.solver(make_augmented_loss(flownet_s_loss, H, W, seed=SEED))
            for b in batches:
                plain.step(b)
            plain_params.append({k: v.detach().clone() for k, v in plain.net.state_dict().items()})
        cache.stop()
    finally:
        torch.backends.cudnn.deterministic = False
    got = cached.net.state_dict()
    diff = max((got[k] - v).abs().max().item() for k, v in plain_params[0].items())
    spread = max((plain_params[1][k] - v).abs().max().item() for k, v in plain_params[0].items())
    moved = max((got[k] - v.to(dev)).abs().max().item() for k, v in rig.start_net.state_dict().items())
    sh, sw = CHAIRS_FRAME
    print(f"[cache] solve_cached K=4 from a 2x{CACHE_SLAB} cache vs the same 4 batches gathered on the host "
          f"through Solver.step, flownets f32 {W}x{H} b{N} from {sw}x{sh}, noise 0, cuDNN deterministic: "
          f"parameters max abs diff {diff:.3g} (two plain runs {spread:.3g}; moved from the start {moved:.3g}); "
          f"launches (K1, K2) in the 4 cached steps {launches}, expected (8, 0)")
    check(moved > 0, "the cached steps did not move the parameters")
    check(diff <= spread, f"solve_cached vs Solver.step: parameters differ by {diff} (plain spread {spread})")
    check(launches == (8, 0), f"cached steps' launches (K1, K2) {launches}, expected (8, 0): 2 K1 a step")
    kernels["flow_warp"]["cache_launches"] = launches[0] // 4
    return dict(max_abs_diff=diff, plain_spread=spread, launches=launches)


def id_samples(start: int = 0):
    """An endless stream of 512x384 transport samples, each filled with its
    own id: images id % 251, flow id % 32000 in both channels, and ``sid``."""
    sh, sw = CHAIRS_FRAME
    i = start
    while True:
        img = np.full((sh, sw, 3), i % 251, np.uint8)
        yield {"img0": img, "img1": img, "flow": np.full((sh, sw, 2), i % 32000, np.int16), "sid": np.int32(i)}
        i += 1


def cache_hazard(rig: CacheRig, steps: int = 64, k: int = 8) -> dict:
    """The refresh hazard: a cache of 4 x 16 samples each filled with its
    own id (:func:`id_samples`), refreshed unthrottled (``min_echo=0``,
    ``link_duty=1``) while ``steps`` steps of ``solve_cached`` run at K =
    ``k``. A chunk reads its slabs once, when it concatenates them, and
    the host drops them when it draws the next chunk; a FlowNetS step
    queues about 700 launches, and the card's queue of pending launches
    (about 1024) keeps the host within two steps of the card, so under the
    net no read of a slab can still be pending when the host drops it. The
    steps here are the gather and a one-parameter loss (a few launches), the
    card sleeps about 0.4 s before each chunk, and the host draws each next
    chunk only after the refresh swapped a slab: the card falls chunks
    behind, and swapped-out slabs lose their last reference while their
    reads are still queued. Every gathered sample must be constant and carry
    the id that the host's copy of its slab held at its index when its
    chunk was drawn: a slab freed and reused by a later upload would show a
    newer id, a torn one a mixed sample. ``slabs_swapped`` > 0. After a
    warm-up chunk the chunks run under ``torch.cuda.set_sync_debug_mode(
    "error")``: no call in them waits for the card."""
    from flownet2_tpu_torch.data.device_cache import CacheChunks, DeviceSampleCache, make_cache_gather_loss
    from flownet2_tpu_torch.train import Solver, SolverConfig

    class IdCache(DeviceSampleCache):
        """Hangs on each uploaded slab's ``sid`` tensor the ids its host copy held."""

        def _build_slab_host(self):
            host = super()._build_slab_host()
            self._ids = host["sid"].numpy().copy()
            return host

        def _build_and_upload(self):
            slab, event = super()._build_and_upload()
            slab["sid"].host_ids = self._ids
            return slab, event

    seen, chunks, resident = [], [], []

    def inspect(net, batch):
        per = [batch[key].flatten(1) for key in ("img0", "img1", "flow")]
        stats = [t for x in per for t in (x.amin(1).long(), x.amax(1).long())]
        seen.append(torch.stack(stats + [batch["sid"].long()], dim=1))
        return (net.weight - per[0].float().mean() / 255).square().sum(), {}

    hazard = IdCache(id_samples(), slab_samples=CACHE_SLAB, n_slabs=CACHE_SLABS, device=rig.dev, min_echo=0,
                     link_duty=1.0)

    def recorded(it):
        for slabs, bank in it:
            # the chunk's draws let the refresh swap once more (min_echo 0)
            swapped = hazard.slabs_swapped
            torch.cuda._sleep(HAZARD_SLEEP_CYCLES)  # queued before the chunk's reads of its slabs
            resident.append(np.concatenate([s["sid"].host_ids for s in slabs]))
            chunks.append(bank["cache_idx"])
            yield slabs, bank
            deadline = time.perf_counter() + 10
            while hazard.slabs_swapped == swapped and time.perf_counter() < deadline:
                time.sleep(0.002)

    net = torch.nn.Module()
    net.weight = torch.nn.Parameter(torch.zeros(1, 1, 1, 1))
    trainer = Solver(SolverConfig(solver_type="sgd", base_lr=1e-3, max_iter=steps), make_cache_gather_loss(inspect),
                     net, device=rig.dev, display=0)
    trainer.sync_bound = 1 << 30  # let the host queue ahead of the card
    chunk_iter = recorded(iter(CacheChunks(hazard, N, k, seed=SEED)))
    try:
        trainer.solve_cached(chunk_iter, max_iter=k, log=lambda m: None)  # the warm-up chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # nothing in a chunk may wait for the card: a synchronizing call raises
        torch.cuda.set_sync_debug_mode("error")
        trainer.solve_cached(chunk_iter, max_iter=steps, log=lambda m: None)
        torch.cuda.set_sync_debug_mode("default")
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
        hazard.stop()
    stats = hazard.stats()
    got = torch.stack(seen).cpu().numpy()  # (steps, N, 7)
    ids = np.stack(resident)  # (chunks, slabs * slab), the host's record
    expect = np.stack([ids[c][chunks[c][i]] for c in range(steps // k) for i in range(k)])
    constant = all((got[..., j] == got[..., j + 1]).all() for j in (0, 2, 4))
    own_ids = bool((got[..., 0] == got[..., 6] % 251).all() and (got[..., 4] == got[..., 6] % 32000).all())
    resident_ok = bool((got[..., 6] == expect).all())
    distinct = len(np.unique(got[..., 6]))
    print(f"[cache] refresh hazard: {CACHE_SLABS}x{CACHE_SLAB} id-filled 512x384 samples refreshed unthrottled "
          f"(min_echo 0, link_duty 1) under {steps} solve_cached steps at K={k} (gather and a one-parameter loss), "
          f"the card sleeping {HAZARD_SLEEP_CYCLES:.0e} cycles before each chunk, the next chunk drawn after a "
          f"swap: {stats['slabs_swapped']} slabs swapped, {stats['samples_uploaded']} samples uploaded "
          f"({stats['bytes_uploaded'] / 1e6:.0f} MB); {steps * N} gathered samples: constant {constant}, carrying "
          f"their own id {own_ids}, each the id its slab's host copy held at its index when its chunk was drawn "
          f"{resident_ok} ({distinct} distinct ids); after the warm-up chunk the host queued {steps - k} steps in "
          f"{queued:.2f} s under sync debug mode 'error', the card finished them at {wall:.2f} s")
    check(stats["slabs_swapped"] > 0, "the refresh swapped no slab")
    check(wall > queued + 0.5, f"the card did not lag the host (queued {queued:.2f} s, done {wall:.2f} s)")
    check(constant and own_ids and resident_ok, "a torn, stale or foreign sample was gathered")
    return dict(stats, distinct_ids=distinct, queued_s=queued, wall_s=wall)


def cache_times(rig: CacheRig, card: str) -> dict:
    """ms a step by CUDA events, median of 32 back-to-back steps after
    warm-ups: the resident batch, the step fed from ``BatchLoader`` over the
    .flowrec through ``DevicePrefetcher`` (cli.train's loader path) and
    directly, the cache at K = 1 and at K = 32 (default throttles); ms a
    batch of the loader alone and through the prefetcher alone (no step,
    host clock); the idle share by the profiler at K = 1 and K = 32."""
    from flownet2_tpu_torch.data import BatchLoader, DevicePrefetcher
    from flownet2_tpu_torch.data.augment_pipeline import make_flownet_augmenter
    from flownet2_tpu_torch.data.device_cache import (
        CacheBatches,
        CacheChunks,
        DeviceSampleCache,
        cycle_dataset,
        make_cache_gather_loss,
    )
    from flownet2_tpu_torch.train import make_multistep_train_step

    dev = rig.dev
    timed = {}

    def loader():
        return iter(BatchLoader(rig.dataset, N, shuffle_seed=SEED, transform=make_flownet_augmenter(H, W)))

    staged, direct = iter(DevicePrefetcher(loader(), device=dev)), loader()
    fed = rig.solver(rig.aug_loss)
    timed["BatchLoader-fed"] = step_times(lambda: fed.step(next(staged)), CACHE_TIMED_STEPS, 6)
    timed["BatchLoader direct"] = step_times(lambda: fed.step(next(direct)), CACHE_TIMED_STEPS, 6)
    resident_batch = {k: torch.as_tensor(v, device=dev) for k, v in next(direct).items()}
    timed["resident batch"] = step_times(lambda: fed.step(resident_batch), CACHE_TIMED_STEPS, 4)
    staged.close()
    direct.close()
    del fed, resident_batch
    # the feeds alone, no step: how fast the loader makes batches, and the
    # prefetcher stages them on the card
    alone = {}
    for label, it in (("BatchLoader alone", loader()), ("through DevicePrefetcher alone",
                                                       iter(DevicePrefetcher(loader(), device=dev)))):
        for _ in range(6):
            next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CACHE_TIMED_STEPS):
            next(it)
        torch.cuda.synchronize()
        alone[label] = (time.perf_counter() - t0) / CACHE_TIMED_STEPS * 1e3
        it.close()

    cache = DeviceSampleCache(cycle_dataset(rig.dataset, seed=SEED), slab_samples=CACHE_SLAB, n_slabs=CACHE_SLABS,
                              device=dev)
    try:
        one = rig.solver(make_cache_gather_loss(rig.aug_loss))
        batches = iter(CacheBatches(cache, N, seed=SEED, aug_sampler=rig.aug_sampler))
        timed["cache K=1"] = step_times(lambda: one.step(next(batches)), CACHE_TIMED_STEPS, 4)
        idle = {"K=1": idle_share(lambda: one.step(next(batches)), CACHE_TIMED_STEPS // 2)}
        del one
        many = rig.solver(make_cache_gather_loss(rig.aug_loss))
        run = make_multistep_train_step(many._loss_fn, many.optimizer)
        chunk_iter = iter(CacheChunks(cache, N, 32, seed=SEED, aug_sampler=rig.aug_sampler))
        timed["cache K=32"] = [t / 32 for t in step_times(lambda: run(many.net, *next(chunk_iter)), 2, 1)]
        idle["K=32"] = idle_share(lambda: run(many.net, *next(chunk_iter)), 1)
    finally:
        cache.stop()
    stats = cache.stats()
    medians = {k: statistics.median(v) for k, v in timed.items()}
    sh, sw = CHAIRS_FRAME
    print(f"[times] train step flownets f32 {W}x{H} b{N} augmented from {sw}x{sh} (.flowrec, {CACHE_FILE_SAMPLES} "
          f"samples), ms a step by CUDA events, median of {CACHE_TIMED_STEPS} back-to-back steps [quartiles]: "
          + ", ".join(f"{k} {quartiles(v)}" for k, v in timed.items())
          + f" (K=32: 2 chunks of 32 steps, each / 32); ms a batch with no step, host clock over "
          f"{CACHE_TIMED_STEPS}: " + ", ".join(f"{k} {v:.3f}" for k, v in alone.items())
          + f"; device idle share by the profiler: K=1 {idle['K=1']:.3f} "
          f"over {CACHE_TIMED_STEPS // 2} steps, K=32 {idle['K=32']:.3f} over one chunk; the timed cache "
          f"{CACHE_SLABS}x{CACHE_SLAB} at default throttles swapped {stats['slabs_swapped']} slabs ({card})")
    check(all(np.isfinite(v) and v > 0 for v in medians.values()), f"step times {medians}")
    return dict(medians=medians, alone_ms=alone, idle=idle, cache_stats=stats)


def phase_cache(dev: torch.device, card: str, kernels: dict) -> dict:
    """The device sample cache and K-step training (``data/device_cache.py``,
    ``Solver.solve_cached``) on the r5 recipe's net, FlowNetS at 448x320 b8,
    augmented from 512x384 transport samples of a synthetic .flowrec:
    :func:`cache_equality`, :func:`cache_hazard`, :func:`cache_times`."""
    results, seconds = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        t0 = time.perf_counter()
        rig = CacheRig(dev, tmp)
        seconds["setup"] = time.perf_counter() - t0
        for label, fn in (("equality", lambda: cache_equality(rig, kernels)), ("hazard", lambda: cache_hazard(rig)),
                          ("times", lambda: cache_times(rig, card))):
            t0 = time.perf_counter()
            results[label] = fn()
            seconds[label] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[cache] parts (s, host clock): {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return results


def main() -> int:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    # float32 convolutions and matmuls in full float32 everywhere (the plain
    # versions and the card-vs-CPU checks need it)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds, t0 = {}, time.perf_counter()

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        return out

    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, dev, smi)
    kernels.update(timed("head kernels", phase_head_kernels, dev, smi))
    kernels.update(timed("1-D kernels", phase_corr1d_kernels, dev, smi))
    timed("slice", phase_slice, dev, smi, kernels)
    timed("sintel", phase_sintel, dev, smi, kernels)
    timed("dispnet", phase_dispnet, dev, smi, kernels)
    timed("train", phase_train, dev, smi, kernels)
    timed("dispnet train", phase_dispnet_train, dev, smi, kernels)
    timed("weights", phase_weights, dev, smi)
    timed("records", phase_records, dev, smi)
    timed("augment", phase_augment, dev, smi, kernels)
    timed("tools", phase_tools, dev, smi)
    timed("dp", phase_dp, dev, smi)
    timed("cache", phase_cache, dev, smi, kernels)
    print(f"[times] phases (s, host clock): {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; "
          f"all {time.perf_counter() - t0:.1f}")
    order = ("flow_warp", "correlation", "flow_warp_backward", "correlation_backward", "head_conv", "head_conv_bf16",
             "fusion_head", "correlation_1d", "correlation_1d_backward")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
