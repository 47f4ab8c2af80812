#!/usr/bin/env python3
"""Where the device time of one FlowNet2 forward, or of one train step,
goes on one CUDA card.

Runs the port's ``FlowRunner.run`` on card tensors (seeded random weights,
seeded uniform images) under ``torch.profiler`` for a few forwards after a
warm-up, per dtype; with ``--train``, ``Solver.step`` (Adam) of the
FlowNetC-stage loss (per dtype) and of the joint FlowNet2 loss (float32)
instead. It prints:

- wall time per batch (CUDA events around the profiled forwards, so it
  includes the profiler's own host cost), device busy time per batch (the
  union of the intervals of every kernel, copy and memset) and the device
  idle share, 1 - busy / wall;
- the share of device busy time in each part of the slice (cuDNN conv and
  deconv, the unfused bias add and leaky ReLU, the hand kernels, and
  cuDNN's layout transposes);
- the profiler's ``key_averages()`` table, sorted by self device time.

    python3 scripts/profile_slice.py                      # 448x320 b8, f32 and bf16
    python3 scripts/profile_slice.py --out build/profile  # also write the full tables
    python3 scripts/profile_slice.py --height 448 --width 1024 --batch 4   # Sintel size
    python3 scripts/profile_slice.py --height 448 --width 1024 --batch 4 --fusion-head
    python3 scripts/profile_slice.py --train              # train steps, 448x320 b8
    python3 scripts/profile_slice.py --head-layers        # K3 per layer at Sintel b4
    python3 scripts/profile_slice.py --corr               # correlation fwd/bwd, K1, K2: device time
    python3 scripts/profile_slice.py --fusion-head-kernel # K4 beside the unfused route: device time
    python3 scripts/profile_slice.py --dispnet            # DispNetC forward and train step, 960x576 b4
    python3 scripts/profile_slice.py --corr1d             # the 1-D correlation kernels and op: device time
    python3 scripts/profile_slice.py --augment            # the augmentation, FlowNetC steps with and without

With ``--dispnet`` it profiles DispNetC instead (default 960x576 b4, the
FlyingThings3D frames adapted): ``FlowRunner("dispnetc").run`` per dtype,
then one float32 Adam ``Solver.step`` of its loss on seeded images and
disparity, each with the 1-D correlation kernels' own rows.
With ``--augment`` it profiles the training augmentation at the paper's
geometry (512x384 sources, uint8 images and int16 flow as a .flowrec batch
holds them, to the 448x320 b8 crop): the augmentation alone, then per dtype
an Adam step of FlowNetC's loss augmented from the sources beside one on
center crops.
With ``--corr1d`` it times the 1-D correlation's kernels (DispNet's md 40,
single_direction -1, stride2 1) at DispNetC's FlyingThings3D features
4x128x144x240 and KITTI's 1x128x96x320 in both dtypes: each wrapper's
kernel alone, then the op as the nets call it (``correlation_1d`` and its
autograd backward on NCHW maps), kernels and everything else it launches
(layout copies) apart. It runs in a parent's tree too: a package whose
1-D wrappers take channels-last maps (the parent of the NCHW kernels) is
given them, so parent and new can be timed in turns in one call.
With ``--head-layers`` it runs K3's wrappers on each of its Sintel b4 layer
shapes (``chip_smoke.HEAD_GEOMETRIES``) and prints, per call, the device
time of the head kernel, of everything else the wrapper launches (the
bfloat16 route's weight packing) and of cuDNN's call on the same tensors.
With ``--corr`` it runs the correlation's wrappers (``correlation_cuda``
and ``correlation_backward_cuda`` for both gradients, FlowNetC's md 20 /
stride2 2 on channels-last features) at the 448x320 b8 and Sintel b4
feature shapes; then K1's and K2's (d_flow only, as the joint step calls
it; both gradients too at 448x320 b8 f32) at the 448x320 b8 and Sintel b4
(4x3x448x1024) images, on two flow fields each: ``chip_smoke._warp_inputs``
(a smooth field plus +-30 px of noise) and the flows the 4 warps of one
FlowNet2 forward take (seeded random weights); it prints each kernel's
device time per call, then the warp kernels' registers and spills from the
build log. To hold the kernels against a parent commit's in one call,
unpack ``git archive <commit>`` into a git-ignored directory, copy this
script and ``chip_smoke.py`` in, and run both trees' copies in turns
(new, parent, new, parent): each imports the package beside it.

TF32 is off, as in chip_smoke.py. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED, WARMUP, STEPS, ROW_LIMIT = 0, 3, 3, 25

# part of the slice -> aten ops whose self device time it is
OP_PARTS = {
    "cuDNN conv (incl. its layout transposes)": ("aten::cudnn_convolution",),
    "cuDNN deconv": ("aten::cudnn_convolution_transpose",),
    "cuDNN conv and deconv backward": ("aten::convolution_backward",),
    "bias add_ (separate kernel)": ("aten::add_",),
    "leaky ReLU (where + ge)": ("aten::where", "aten::ge"),
    "layout copies (copy_, clone)": ("aten::copy_", "aten::clone"),
}
HEAD_PART = "head_conv kernels (K3: conv and deconv; f32 CUDA cores, bf16 tensor cores)"
# part of the slice -> substrings of the device kernels' names
KERNEL_PARTS = {
    "correlation kernel": ("correlation_kernel",),
    "correlation backward kernel": ("correlation_backward_kernel",),
    "correlation_1d kernel": ("correlation1d_kernel",),
    "correlation_1d backward kernel": ("correlation1d_backward_kernel",),
    "flow_warp kernel": ("flow_warp_kernel",),
    "flow_warp backward kernel": ("flow_warp_backward_kernel",),
    HEAD_PART: (
        "head_conv_f32_kernel", "head_conv_mma_kernel"),
    "fusion_head kernel (K4)": ("fusion_head",),
    "cuDNN NCHW->NHWC transposes": ("nchwToNhwc",),
    "cuDNN NHWC->NCHW transposes": ("nhwcToNchw",),
}


def busy_us(prof) -> float:
    """Length of the union of the device's kernel, copy and memset
    intervals, in us. User annotations are left out: the device-side span
    of one (``Optimizer.step``'s) covers the gaps between its kernels."""
    ivs = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    total, cur_start, cur_end = 0.0, None, None
    for s, e in ivs:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def parts_us(prof) -> dict[str, float]:
    """Self device time in us of each part of OP_PARTS and KERNEL_PARTS."""
    rows = prof.key_averages()
    out = {}
    for part, ops in OP_PARTS.items():
        out[part] = sum(r.self_device_time_total for r in rows if r.key in ops)
    for part, patterns in KERNEL_PARTS.items():
        out[part] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and any(p in e.name for p in patterns)
        )
    return out


def profile_run(args, label: str, run) -> str:
    """Profile ``STEPS`` calls of ``run`` after ``WARMUP``; the report as text."""
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(STEPS):
            run()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / STEPS
    busy = busy_us(prof) / 1e3 / STEPS
    lines = [f"== {label}: wall {wall:.3f} ms/call, device busy {busy:.3f} ms/call, "
             f"idle share {1 - busy / wall:.3f}"]
    for part, us in parts_us(prof).items():
        lines.append(f"   {part}: {us / 1e3 / STEPS:.3f} ms/call, {us / 1e3 / STEPS / busy:.1%} of busy")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=ROW_LIMIT)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_{label.replace(' ', '_')}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n" + prof.key_averages().table(sort_by="self_device_time_total"))
    return "\n".join(lines) + "\n" + table


def _images(args, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(SEED)
    return tuple(
        torch.as_tensor(rng.uniform(0, 255, (args.batch, args.height, args.width, 3)).astype(np.float32),
                        device=dev)
        for _ in range(2)
    )


def profile_dtype(args, dtype: str, dev: torch.device) -> str:
    from flownet2_tpu_torch.checkpoint import init_params
    from flownet2_tpu_torch.inference import FlowRunner

    runner = FlowRunner("flownet2", init_params("flownet2", seed=SEED), device=dev, dtype=dtype,
                        fusion_head=args.fusion_head)
    i0, i1 = _images(args, dev)
    label = f"{dtype} {args.width}x{args.height} b{args.batch}{' fused head' if args.fusion_head else ''}"
    return profile_run(args, label, lambda: runner.run(i0, i1))


def profile_train(args, objective: str, dtype: str, dev: torch.device) -> str:
    """Adam ``Solver.step`` of FlowNetC's loss or the joint FlowNet2 loss,
    computed in ``dtype`` over float32 master weights."""
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.models import NETS
    from flownet2_tpu_torch.train import Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import flownet2_loss, flownet_c_loss, with_compute_dtype

    model, loss_fn = {"flownetc": ("flownetc", flownet_c_loss), "joint": ("flownet2", flownet2_loss)}[objective]
    if dtype != "float32":
        loss_fn = with_compute_dtype(loss_fn, getattr(torch, dtype))
    with torch.device("meta"):
        net = NETS[model]()
    solver = Solver(SolverConfig(solver_type="adam"), loss_fn, load_into(net, init_params(model, seed=SEED)),
                    device=dev)
    i0, i1 = _images(args, dev)
    flow = torch.randn(args.batch, args.height, args.width, 2, generator=torch.Generator().manual_seed(SEED))
    batch = {"img0": i0, "img1": i1, "flow": (4 * flow).to(dev)}
    return profile_run(args, f"train {objective} {dtype}", lambda: solver.step(batch))


def profile_dispnet(args, dev: torch.device) -> str:
    """DispNetC: FlowRunner forwards per dtype, then one float32 Adam step of
    its loss (seeded images, seeded disparity up to 30 px)."""
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.inference import FlowRunner
    from flownet2_tpu_torch.models import DispNetC
    from flownet2_tpu_torch.train import Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import dispnet_c_loss

    params = init_params("dispnetc", seed=SEED)
    i0, i1 = _images(args, dev)
    geom = f"{args.width}x{args.height} b{args.batch}"
    reports = []
    for dtype in args.dtypes:
        runner = FlowRunner("dispnetc", params, device=dev, dtype=dtype)
        reports.append(profile_run(args, f"dispnetc {dtype} {geom}", lambda: runner.run(i0, i1)))
        del runner
    with torch.device("meta"):
        net = DispNetC()
    solver = Solver(SolverConfig(solver_type="adam"), dispnet_c_loss, load_into(net, params), device=dev)
    disp = torch.rand(args.batch, args.height, args.width, 1, generator=torch.Generator().manual_seed(SEED))
    batch = {"img0": i0, "img1": i1, "flow": (-30 * disp).to(dev)}
    reports.append(profile_run(args, f"train dispnetc float32 {geom}", lambda: solver.step(batch)))
    return "\n".join(reports + ["registers and spills (nvcc -Xptxas -v):", *kernel_resources("correlation1d")])


def profile_augment(args, dev: torch.device) -> str:
    """The training augmentation at the paper's geometry: FlyingChairs'
    512x384 sources to ``args``' crop (448x320 b8), in the transport types
    of a .flowrec batch (uint8 images, int16 flow), seeded. The
    augmentation alone (both frames, flow, chromatic, noise), then per
    dtype Adam steps of FlowNetC's loss augmented from the sources beside
    steps on the center crops."""
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.core.codec import encode_flow_int16
    from flownet2_tpu_torch.data.augment_pipeline import (
        FlowNetAugConfig,
        apply_augmentation_device,
        make_augmented_loss,
        sample_aug_arrays,
    )
    from flownet2_tpu_torch.models import FlowNetC
    from flownet2_tpu_torch.train import Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import flownet_c_loss, with_compute_dtype

    n, h, w, (sh, sw) = args.batch, args.height, args.width, (384, 512)
    rng = np.random.default_rng(SEED)
    host = {"img0": rng.integers(0, 256, (n, sh, sw, 3), dtype=np.uint8),
            "img1": rng.integers(0, 256, (n, sh, sw, 3), dtype=np.uint8),
            "flow": encode_flow_int16(rng.normal(0, 4, (n, sh, sw, 2)))}
    host.update(sample_aug_arrays(FlowNetAugConfig(), rng, n, sh, sw, h, w))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def augment():
        with torch.no_grad():
            apply_augmentation_device(batch, gen, h, w)

    reports = [profile_run(args, f"augment {sw}x{sh} to {w}x{h} b{n}", augment)]
    y0, x0 = (sh - h) // 2, (sw - w) // 2
    cropped = {k: batch[k][:, y0:y0 + h, x0:x0 + w].contiguous() for k in ("img0", "img1", "flow")}
    params = init_params("flownetc", seed=SEED)
    for dtype in args.dtypes:
        loss_fn = flownet_c_loss if dtype == "float32" else with_compute_dtype(flownet_c_loss, getattr(torch, dtype))
        for label, fn, b in (("augmented", make_augmented_loss(loss_fn, h, w, seed=SEED), batch),
                             ("center crops", loss_fn, cropped)):
            with torch.device("meta"):
                net = FlowNetC()
            solver = Solver(SolverConfig(solver_type="adam"), fn, load_into(net, params), device=dev)
            reports.append(profile_run(args, f"train flownetc {dtype} {label}", lambda: solver.step(b)))
            del solver, net
    return "\n".join(reports)


def _device_us(run, patterns, require: bool = True) -> dict[str, float]:
    """Device time per call of ``run`` in us, split into the kernels whose
    names contain one of ``patterns`` and the rest, over ``STEPS`` calls
    after ``WARMUP``. Where ``require``, a trace in which no such kernel
    shows (the profiler has returned one without device events) is taken
    again, and after three such traces it raises."""
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                run()
            torch.cuda.synchronize()
        out = {"kernel": 0.0, "other": 0.0}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                mine = any(p in e.name for p in patterns)
                out["kernel" if mine else "other"] += e.time_range.elapsed_us() / STEPS
        if out["kernel"] > 0 or not require:
            return out
    raise RuntimeError(f"profile_slice: no device event of a kernel named {patterns} in three traces")


def profile_head_layers(args, dev: torch.device) -> str:
    """K3's wrappers and cuDNN at each Sintel b4 head-layer shape."""
    import torch.nn.functional as F

    from chip_smoke import HEAD_GEOMETRIES
    from flownet2_tpu_torch.ops.head_conv import head_conv2d_cuda, head_deconv2d_cuda

    g = torch.Generator().manual_seed(SEED)
    lines = []
    for label, x_shape, w_shape, stride, leaky, count in HEAD_GEOMETRIES:
        x32 = torch.randn(x_shape, generator=g)
        w32 = torch.randn(w_shape, generator=g) * 0.1
        b32 = torch.randn(w_shape[1] if stride == 0 else w_shape[0], generator=g)
        for dtype in args.dtypes:
            x, w, b = (t.to(dev, getattr(torch, dtype)) for t in (x32, w32, b32))
            head = KERNEL_PARTS[HEAD_PART]
            if stride == 0:
                ours = _device_us(lambda: head_deconv2d_cuda(x, w, b, leaky=leaky), head)
                lib = _device_us(lambda: F.conv_transpose2d(x, w, b, stride=2, padding=1), head, require=False)
            else:
                ours = _device_us(lambda: head_conv2d_cuda(x, w, b, stride=stride, leaky=leaky), head)
                lib = _device_us(lambda: F.conv2d(x, w, b, stride=stride, padding=w_shape[-1] // 2), head,
                                require=False)
            lines.append(f"{label} {dtype}: head kernel {ours['kernel'] / 1e3:.4f} ms, other "
                         f"{ours['other'] / 1e3:.4f} ms, cuDNN call {(lib['kernel'] + lib['other']) / 1e3:.4f} "
                         f"ms per call; {count} per forward")
            del x, w, b
        torch.cuda.empty_cache()
    return "\n".join(lines)


def profile_fusion_head(args, dev: torch.device) -> str:
    """K4 (``fusion_head_cuda``) at ``chip_smoke.FUSION_HEAD_GEOMETRIES``
    per dtype: the kernel's device time per call, the rest of the wrapper's
    (weight packing), and every device event of the unfused route it
    replaces (``FlowNetFusion.head_unfused``, where the package has it);
    then the K4 kernels' registers and spills."""
    import copy

    from chip_smoke import FUSION_HEAD_GEOMETRIES, fusion_head_flops
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.models import FlowNet2
    from flownet2_tpu_torch.ops.fusion_head import fusion_head_cuda, head_weights

    with torch.device("meta"):
        net = FlowNet2()
    fusion32 = load_into(net, init_params("flownet2", seed=SEED)).fusion.to(dev)
    g = torch.Generator().manual_seed(SEED)
    pattern = KERNEL_PARTS["fusion_head kernel (K4)"]
    lines = []
    for label, n, h, w in FUSION_HEAD_GEOMETRIES:
        cat32, c032 = torch.randn(n, 162, h // 2, w // 2, generator=g), torch.randn(n, 64, h, w, generator=g)
        for dtype in args.dtypes:
            fusion = copy.deepcopy(fusion32).to(getattr(torch, dtype))
            cat1, c0 = (t.to(dev, getattr(torch, dtype)) for t in (cat32, c032))
            weights = head_weights(fusion)
            with torch.no_grad():
                ours = _device_us(lambda: fusion_head_cuda(cat1, c0, *weights), pattern)
                line = (f"fusion_head {label} {dtype}: kernel {ours['kernel'] / 1e3:.4f} ms "
                        f"({fusion_head_flops(n, h, w) / ours['kernel'] / 1e6:.2f} TFLOP/s), other "
                        f"{ours['other'] / 1e3:.4f} ms per call")
                if hasattr(fusion, "head_unfused"):
                    unfused = _device_us(lambda: fusion.head_unfused(cat1, c0), pattern, require=False)
                    line += f"; unfused route {(unfused['kernel'] + unfused['other']) / 1e3:.4f} ms"
            lines.append(line)
            del cat1, c0, fusion, weights
            torch.cuda.empty_cache()
    return "\n".join(lines + kernel_resources("fusion_head"))


def forward_warp_inputs(dev: torch.device, n: int, h: int, w: int) -> list:
    """The (image, flow) pairs, float32, that the 4 warps of one FlowNet2
    forward (seeded random weights, seeded uniform images) hand to K1."""
    import flownet2_tpu_torch.ops.warp as warp_ops
    from flownet2_tpu_torch.checkpoint import init_params
    from flownet2_tpu_torch.inference import FlowRunner

    runner = FlowRunner("flownet2", init_params("flownet2", seed=SEED), device=dev)
    rng = np.random.default_rng(SEED)
    i0, i1 = (torch.as_tensor(rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32), device=dev) for _ in range(2))
    calls, function = [], warp_ops._FlowWarpCuda

    class Record:  # flow_warp's autograd Function, recording its inputs
        @staticmethod
        def apply(image, flow, fill_value):
            calls.append((image.detach().clone(), flow.detach().clone()))
            return function.apply(image, flow, fill_value)

    warp_ops._FlowWarpCuda = Record
    try:
        with torch.no_grad():
            runner.run(i0, i1)
    finally:
        warp_ops._FlowWarpCuda = function
    return calls


def kernel_resources(pattern: str) -> list[str]:
    """Registers and spills of the built kernels whose names contain
    ``pattern``, from nvcc's ``-Xptxas -v`` log."""
    from flownet2_tpu_torch import _build

    rows, name = {}, None
    for line in _build.build().log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if line.count("'") >= 2 else line.strip()
        elif name and pattern in name and ("registers" in line or "spill" in line):
            rows.setdefault(name, []).append(line.split("info    :")[-1].strip())
    return [f"  {k}: {'; '.join(v)}" for k, v in rows.items()]


def profile_warp(dev: torch.device, dtypes) -> list[str]:
    """K1 and K2 (d_flow only, as the joint step asks; both gradients too at
    448x320 b8 f32) at FlowNet2's two geometries, on chip_smoke's
    _warp_inputs field and on the flows one forward's 4 warps take; beside
    them, on the _warp_inputs field, the device time of the nearest library
    calls (chip_smoke.phase_warp_geometries): grid_sample and its backward
    with output_mask [False, True]."""
    import torch.nn.functional as F

    from chip_smoke import H, N, SINTEL_H, SINTEL_N, SINTEL_W, W, _sample_grid, _warp_inputs
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda

    k1_pat, k2_pat = KERNEL_PARTS["flow_warp kernel"], KERNEL_PARTS["flow_warp backward kernel"]

    def library_ms(run) -> float:  # every device event of the call
        t = _device_us(run, k1_pat, require=False)
        return (t["kernel"] + t["other"]) / 1e3

    lines = []
    for n, h, w in ((N, H, W), (SINTEL_N, SINTEL_H, SINTEL_W)):
        fields = [("_warp_inputs field", [_warp_inputs(dev, n, h, w)])]
        own = forward_warp_inputs(dev, n, h, w)
        mean_flow = np.mean([f.abs().mean().item() for _, f in own])
        fields.append((f"one forward's {len(own)} warps (mean |flow| {mean_flow:.3g} px)", own))
        for label, pairs in fields:
            for dtype in dtypes:
                k1, k2 = [], []
                for img32, flow32 in pairs:
                    img, flow = img32.to(getattr(torch, dtype)), flow32.to(getattr(torch, dtype))
                    grad = torch.randn(img.shape, generator=torch.Generator().manual_seed(SEED)).to(img)
                    k1.append(_device_us(lambda: flow_warp_cuda(img, flow), k1_pat)["kernel"] / 1e3)
                    k2.append(_device_us(lambda: flow_warp_backward_cuda(img, flow, grad, need_image=False),
                                         k2_pat)["kernel"] / 1e3)
                    if len(pairs) == 1:  # the _warp_inputs field
                        if (n, dtype) == (N, "float32"):
                            both = _device_us(lambda: flow_warp_backward_cuda(img, flow, grad), k2_pat)["kernel"]
                            k2.append(f"both gradients {both / 1e3:.4f}")
                        grid = _sample_grid(flow32, img.dtype)
                        lib1 = library_ms(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                                                align_corners=True))
                        lib2 = library_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                            grad, img, grid, 0, 1, True, [False, True]))
                        k1.append(f"grid_sample {lib1:.4f}")
                        k2.append(f"grid_sampler_2d_backward (d_grid only) {lib2:.4f}")
                lines.append(f"flow_warp {n}x3x{h}x{w} {dtype}, {label}: K1 "
                             f"{', '.join(t if isinstance(t, str) else f'{t:.4f}' for t in k1)} ms per call; "
                             f"K2 d_flow only {', '.join(t if isinstance(t, str) else f'{t:.4f}' for t in k2)} "
                             f"ms per call")
        del fields, own
        torch.cuda.empty_cache()
    return lines + ["registers and spills (nvcc -Xptxas -v):", *kernel_resources("flow_warp")]


def profile_corr(args, dev: torch.device) -> str:
    """The correlation forward's and backward's kernels at FlowNetC's two
    feature shapes, then K1 and K2 (:func:`profile_warp`)."""
    from chip_smoke import CORR_SHAPE, CORR_SINTEL_SHAPE
    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda

    g = torch.Generator().manual_seed(SEED)
    lines = []
    for n, c, h, w in (CORR_SHAPE, CORR_SINTEL_SHAPE):
        f1, f2 = (torch.randn(n, h, w, c, generator=g) for _ in range(2))
        grad = torch.randn(n, 441, h, w, generator=g)
        for dtype in args.dtypes:
            a, b, gr = (t.to(dev, getattr(torch, dtype)) for t in (f1, f2, grad))
            fwd = _device_us(lambda: correlation_cuda(a, b, max_displacement=20, stride2=2),
                             KERNEL_PARTS["correlation kernel"])
            bwd = _device_us(lambda: correlation_backward_cuda(a, b, gr, max_displacement=20, stride2=2),
                             KERNEL_PARTS["correlation backward kernel"])
            lines.append(f"correlation {n}x{c}x{h}x{w} -> 441 {dtype}: kernel {fwd['kernel'] / 1e3:.4f} ms per "
                         f"call; backward (df1 and df2) kernel {bwd['kernel'] / 1e3:.4f} ms per call")
            del a, b, gr
    return "\n".join(lines + profile_warp(dev, args.dtypes))


def profile_corr1d(args, dev: torch.device) -> str:
    """The 1-D correlation's kernels, and the op around them, at DispNetC's
    two feature shapes (``chip_smoke.CORR1D_SHAPE``, ``CORR1D_KITTI_SHAPE``)."""
    from chip_smoke import CORR1D, CORR1D_KITTI_SHAPE, CORR1D_SHAPE
    from flownet2_tpu_torch.ops.correlation import correlation_1d, correlation_1d_backward_cuda, correlation_1d_cuda

    nchw = "(N, C, H, W)" in correlation_1d_cuda.__doc__  # else a parent's channels-last wrappers
    kw = dict(max_displacement=40, stride2=1, single_direction=-1)
    fwd_k, bwd_k = KERNEL_PARTS["correlation_1d kernel"], KERNEL_PARTS["correlation_1d backward kernel"]
    g = torch.Generator().manual_seed(SEED)
    lines = [f"correlation_1d wrappers take {'NCHW' if nchw else 'NHWC'} maps"]
    for n, c, h, w in (CORR1D_SHAPE, CORR1D_KITTI_SHAPE):
        f1, f2 = (torch.randn(n, c, h, w, generator=g) for _ in range(2))
        grad = torch.randn(n, 41, h, w, generator=g)
        for dtype in args.dtypes:
            a, b, gr = (t.to(dev, getattr(torch, dtype)) for t in (f1, f2, grad))
            ak, bk = (a, b) if nchw else (a.permute(0, 2, 3, 1).contiguous(), b.permute(0, 2, 3, 1).contiguous())
            fwd = _device_us(lambda: correlation_1d_cuda(ak, bk, **kw), fwd_k)
            bwd = _device_us(lambda: correlation_1d_backward_cuda(ak, bk, gr, **kw), bwd_k)
            del ak, bk
            a.requires_grad_(True)
            b.requires_grad_(True)
            op_f = _device_us(lambda: correlation_1d(a, b, **CORR1D), fwd_k)
            op_b = _device_us(lambda: torch.autograd.grad(correlation_1d(a, b, **CORR1D), (a, b), gr),
                              fwd_k + bwd_k)
            lines.append(
                f"correlation_1d {n}x{c}x{h}x{w} -> 41 {dtype}: forward kernel {fwd['kernel'] / 1e3:.4f} ms, "
                f"backward (df1 and df2) kernel {bwd['kernel'] / 1e3:.4f} ms per call; the op on NCHW maps: "
                f"forward {(op_f['kernel'] + op_f['other']) / 1e3:.4f} ms (copies and other "
                f"{op_f['other'] / 1e3:.4f}), forward and backward {(op_b['kernel'] + op_b['other']) / 1e3:.4f} "
                f"ms (copies and other {op_b['other'] / 1e3:.4f})")
            del a, b, gr
        torch.cuda.empty_cache()
    return "\n".join(lines + ["registers and spills (nvcc -Xptxas -v):", *kernel_resources("correlation1d")])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=None, help="default 320; 576 with --dispnet")
    p.add_argument("--width", type=int, default=None, help="default 448; 960 with --dispnet")
    p.add_argument("--batch", type=int, default=None, help="default 8; 4 with --dispnet")
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
    p.add_argument("--out", default=None, help="directory for the full key_averages tables")
    p.add_argument("--train", action="store_true", help="profile train steps instead of forwards")
    p.add_argument("--fusion-head", action="store_true", help="FlowNet2 with the fused fusion-net decoder head")
    p.add_argument("--head-layers", action="store_true", help="K3 and cuDNN per head layer at Sintel b4")
    p.add_argument("--fusion-head-kernel", action="store_true",
                   help="K4 and the unfused route it replaces at Sintel b4 and 448x320 b8: device time")
    p.add_argument("--corr", action="store_true",
                   help="the correlation forward and backward at 448x320 b8 and Sintel b4, K1 and K2")
    p.add_argument("--dispnet", action="store_true", help="DispNetC's forward and train step (960x576 b4)")
    p.add_argument("--corr1d", action="store_true",
                   help="the 1-D correlation kernels and op at 4x128x144x240 and 1x128x96x320: device time")
    p.add_argument("--augment", action="store_true",
                   help="the training augmentation, 512x384 to 448x320 b8, and FlowNetC steps with and without it")
    args = p.parse_args(argv)
    defaults = (576, 960, 4) if args.dispnet else (320, 448, 8)
    args.height, args.width, args.batch = (v or d for v, d in zip((args.height, args.width, args.batch), defaults))
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    net = "DispNetC" if args.dispnet else "FlowNet2"
    print(f"{net} {args.width}x{args.height} b{args.batch}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.head_layers:
        print(profile_head_layers(args, dev))
    elif args.fusion_head_kernel:
        print(profile_fusion_head(args, dev))
    elif args.corr:
        print(profile_corr(args, dev))
    elif args.corr1d:
        print(profile_corr1d(args, dev))
    elif args.dispnet:
        print(profile_dispnet(args, dev))
    elif args.augment:
        print(profile_augment(args, dev))
    elif args.train:
        for dtype in args.dtypes:
            print(profile_train(args, "flownetc", dtype, dev))
        print(profile_train(args, "joint", "float32", dev))
    else:
        for dtype in args.dtypes:
            print(profile_dtype(args, dtype, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
