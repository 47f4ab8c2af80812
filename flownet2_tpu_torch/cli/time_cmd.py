"""time on PyTorch: forward/backward timing (the ``caffe time`` profiler,
tools/caffe.cpp:302-388).

Flag-compatible with flownet2_tpu/cli/time_cmd.py:

    python -m flownet2_tpu_torch.cli.time_cmd [--model flownet2] [--height 320]
        [--width 448] [--batch 1] [--iterations 20] [--backward]
        [--dtype float32|bfloat16] [--breakdown] [--profile DIR]
        [--gpu N | --device cpu]

- seeded random weights (``checkpoint.init_params(model, seed=0)``) and
  random frames at the given size (a multiple of 64: the net's own
  forward, no adapt);
- ``forward`` and, with ``--backward``, ``forward+backward`` (the gradient
  of the model's objective, ``train.objectives.LOSSES``, and for flownet2
  the joint loss, with respect to every weight, on a random target of the
  objective's layout: 1-channel disparity for dispnetc, else flow): ms a call by CUDA events
  over ``--iterations`` calls after warm-ups, pairs/s, and as "compile" the
  seconds of the first call, the kernels' build included;
- ``--breakdown``: the per-stage table (``tools/breakdown.py``: each
  cascade stage timed alone, forward and with ``--backward`` forward plus
  backward) with its count-weighted sum beside the whole program;
- ``--profile DIR``: a ``torch.profiler`` Chrome trace of one forward,
  ``DIR/trace.json``.

On the CPU (``--device cpu``) the times are the host clock's. Without a
card and without ``--device`` the CLI exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="flownet2")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--backward", action="store_true", help="also time fwd+bwd")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--profile", default=None, help="write a torch.profiler Chrome trace into this directory")
    p.add_argument("--breakdown", action="store_true",
                   help="per-stage cost table (the caffe time per-layer report at cascade-stage granularity)")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    return p


def objective(model: str):
    """The loss ``--backward`` differentiates, or None."""
    from flownet2_tpu_torch.train.objectives import LOSSES, flownet2_loss

    return flownet2_loss if model == "flownet2" else LOSSES.get(model)


def print_breakdown(stages, backward: bool) -> None:
    """The per-stage table, then its count-weighted sums."""
    hdr = f"{'stage':<20} {'shape':>11} {'count':>5} {'fwd ms':>9}"
    if backward:
        hdr += f" {'bwd ms':>9} {'f+b ms':>9}"
    print(hdr)
    fwd_total = fb_total = 0.0
    for st in stages:
        shape = "x".join(str(d) for hw in st.spatial() for d in hw)[:9]
        row = f"{st.name:<20} {shape:>11} {st.count:>5} {st.fwd_ms:>9.3f}"
        fwd_total += st.count * st.fwd_ms
        if backward:
            row += f" {st.bwd_ms:>9.3f} {st.fwdbwd_ms:>9.3f}"
            if st.fwdbwd_ms == st.fwdbwd_ms:  # not NaN
                fb_total += st.count * st.fwdbwd_ms
        print(row)
    # count-weighted sums cross-check the whole-program numbers above
    total_row = f"{'sum (count-weighted)':<20} {'':>11} {'':>5} {fwd_total:>9.3f}"
    if backward:
        total_row += f" {'':>9} {fb_total:>9.3f}"
    print(total_row + "   vs whole-program above")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.cli.run_flownet import device_from_args
    from flownet2_tpu_torch.inference import _make_forward, check_model
    from flownet2_tpu_torch.models import NETS
    from flownet2_tpu_torch.tools.breakdown import time_ms, time_stages, walk_stages

    try:
        check_model(args.model)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.model not in NETS:
        raise SystemExit(f"time_cmd times the FlowNet models {tuple(NETS)}, not {args.model!r}")
    device = torch.device(device_from_args(args))
    dtype = getattr(torch, args.dtype)
    with torch.device("meta"):
        net = NETS[args.model]()
    net = load_into(net, init_params(args.model, seed=0)).to(device=device, dtype=dtype).eval()
    rng = np.random.default_rng(0)
    shape = (args.batch, 3, args.height, args.width)
    img0 = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32)).to(device=device, dtype=dtype)
    img1 = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32)).to(device=device, dtype=dtype)
    forward = _make_forward(args.model)

    def run_timed(name, fn):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
        ms = time_ms(fn, device, warmup=2, runs=args.iterations)
        print(f"{name}: {ms:.3f} ms/iter ({args.batch / (ms / 1000):.1f} pairs/s, compile {first_s:.1f}s)")

    def fwd():
        with torch.inference_mode():
            return forward(net, img0, img1)

    run_timed("forward", fwd)

    loss_fn = objective(args.model)
    if args.backward and loss_fn is not None:
        # the target's layout is the objective's: (N, H, W, 1) disparity for dispnetc, else flow
        channels = 1 if args.model == "dispnetc" else 2
        target = rng.uniform(-5, 5, (args.batch, args.height, args.width, channels)).astype(np.float32)
        batch = {
            "img0": img0.permute(0, 2, 3, 1),
            "img1": img1.permute(0, 2, 3, 1),
            "flow": torch.as_tensor(target, device=device),
        }
        params = list(net.parameters())

        def fwdbwd():
            return torch.autograd.grad(loss_fn(net, batch)[0], params)

        run_timed("forward+backward", fwdbwd)
    elif args.backward:
        print(f"forward+backward: no objective trains {args.model}")

    if args.breakdown:
        warmup, runs = (1, 3) if device.type == "cpu" else (3, 10)
        stages = walk_stages(args.model, net, img0, img1)
        time_stages(stages, device, warmup=warmup, runs=runs, backward=args.backward)
        print_breakdown(stages, args.backward)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=activities) as prof:
            fwd()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
