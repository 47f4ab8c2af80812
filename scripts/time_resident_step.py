#!/usr/bin/env python3
"""Time one augmented FlowNetS train step on a card-resident batch (448x320
crops of 512x384 b8 sources, Adam, float32) of the package under a source
tree: the median [quartiles] of 32 back-to-back steps by CUDA events after 6
warm-ups, and the device idle share by ``torch.profiler`` over 16 more.

To hold a change against its parent in one call, unpack ``git archive
<parent>`` into a git-ignored directory and run this script on both trees
in turns (parent, change, change, parent, ...):

    python3 scripts/time_resident_step.py --tree build/parent --label parent
    python3 scripts/time_resident_step.py --tree . --label change

Imports neither jax nor the JAX package; TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tree", default=".", help="the source tree whose flownet2_tpu_torch is timed")
    p.add_argument("--label", default="change")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("time_resident_step: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from flownet2_tpu_torch._build import build
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.data.augment_pipeline import FlowNetAugConfig, make_augmented_loss, sample_aug_arrays
    from flownet2_tpu_torch.models import FlowNetS
    from flownet2_tpu_torch.train import Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import flownet_s_loss

    build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    batch = {"img0": rng.integers(0, 256, (8, 384, 512, 3), dtype=np.uint8),
             "img1": rng.integers(0, 256, (8, 384, 512, 3), dtype=np.uint8),
             "flow": rng.normal(0, 3, (8, 384, 512, 2)).astype(np.float32)}
    batch.update(sample_aug_arrays(FlowNetAugConfig(), rng, 8, 384, 512, 320, 448))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.device("meta"):
        net = FlowNetS()
    load_into(net, init_params("flownets", seed=0))
    solver = Solver(SolverConfig(solver_type="adam", base_lr=2e-4, max_iter=10**6),
                    make_augmented_loss(flownet_s_loss, 320, 448), net, device=dev, display=0)
    for _ in range(6):
        solver.step(batch)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(33)]
    events[0].record()
    for e in events[1:]:
        solver.step(batch)
        e.record()
    events[-1].synchronize()
    q1, q2, q3 = statistics.quantiles([a.elapsed_time(b) for a, b in zip(events, events[1:])], n=4)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            solver.step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy, start, end = 0.0, None, None
    for s, e in intervals:
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += 0.0 if end is None else end - start
    print(f"[step] {args.label}: resident augmented flownets f32 step 448x320 b8 from 512x384: {q2:.3f} "
          f"[{q1:.3f}, {q3:.3f}] ms; device idle share {1 - busy / wall_us:.3f} ({torch.cuda.get_device_name(0)})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
