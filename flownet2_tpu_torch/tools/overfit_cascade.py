"""Stage-wise FlowNet2 cascade training to convergence, offline (the port of
flownet2_tpu/tools/overfit_cascade.py).

The reference trains the stacked nets stage by stage (README.md:100-106
recipe; solver.cpp:194-324 loop): FlowNetC first, then each S refinement
with the upstream frozen, then SD, then the fusion net. This tool runs that
recipe end to end on the 8 pairs of a FlyingChairs-layout directory
(``tools/overfit.load_examples``) and produces a full FlowNet2 checkpoint:

- the c stage runs the correlation forward and backward kernels;
- s1 and s2 the warp (frozen upstream: ``train.objectives``' stage losses);
- sd the small-displacement net; fusion the whole frozen cascade forward.

Each stage trains its sub-net alone (``Solver(trainable=...)``) with Adam
(eps 1e-12) cosine-decayed to 0 over ``--iters``; the loss is read back
once every ``--chunk`` steps. After each stage the cascade EPE over the
pairs is reported. Writes under ``--out``: ``log_<stage>.txt`` (the solver
format, for tools/parse_log.py), ``results.json`` ({"init_epe", "stages":
{stage: {"first_loss", "final_loss", "cascade_epe"}}, "final_epe"}) and
``flownet2_staged.npz`` (the JAX package's flat layout, which ``cli.test``
and ``run_flownet`` read). Exits 0 only if the final cascade EPE is below
half the initial one.

Usage:
  python -m flownet2_tpu_torch.tools.overfit_cascade --data DIR --iters 800 --out build/cascade
      [--gpu N | --device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STAGES = ("c", "s1", "s2", "sd", "fusion")


def cascade_epe(net, batch: dict) -> float:
    """EPE of the whole FlowNet2 forward over ``batch`` (NHWC, at a size
    divisible by 64)."""
    import torch

    from flownet2_tpu_torch.models.common import to_nchw
    from flownet2_tpu_torch.models.flownet2 import flownet2_forward
    from flownet2_tpu_torch.ops.losses import epe

    with torch.no_grad():
        flow = flownet2_forward(net, to_nchw(batch["img0"]), to_nchw(batch["img1"]))
        return float(epe(flow, to_nchw(batch["flow"])))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="/root/reference/data/FlyingChairs_examples")
    p.add_argument("--iters", type=int, default=800, help="iterations per stage")
    p.add_argument("--chunk", type=int, default=50, help="steps between loss read-backs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--out", default="build/cascade", help="output dir (logs + checkpoint)")
    p.add_argument("--stages", default=",".join(STAGES), help="comma-separated subset of c,s1,s2,sd,fusion")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype (bfloat16 = mixed precision, f32 master weights)")
    p.add_argument("--init-from", default=None, metavar="NPZ",
                   help="start from a saved flownet2_staged.npz instead of random init "
                   "(stage-by-stage experiments without retraining the upstream)")
    p.add_argument("--reinit", default="", metavar="STAGES",
                   help="comma list of stages whose sub-net is re-randomized after --init-from "
                   "(e.g. --reinit fusion to train fusion from scratch on a trained upstream)")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    args = p.parse_args(argv)
    stages = args.stages.split(",")
    unknown = sorted(set(stages + [s for s in args.reinit.split(",") if s]) - set(STAGES))
    if unknown:
        raise SystemExit(f"unknown stage(s) {unknown}; choose from {STAGES}")

    import torch

    from flownet2_tpu_torch.checkpoint import (
        init_params,
        load_into,
        load_params,
        params_from_state_dict,
        save_params,
        state_dict_from_params,
    )
    from flownet2_tpu_torch.cli.run_flownet import device_from_args
    from flownet2_tpu_torch.models import FlowNet2
    from flownet2_tpu_torch.tools.overfit import load_examples, make_solver
    from flownet2_tpu_torch.train.objectives import LOSSES, STAGE_LOSS_KEY, STAGE_SUBTREE, with_compute_dtype

    device = device_from_args(args)
    os.makedirs(args.out, exist_ok=True)
    img0, img1, flow = load_examples(args.data, (args.height, args.width))
    batch = {k: torch.as_tensor(v, device=device) for k, v in (("img0", img0), ("img1", img1), ("flow", flow))}

    fresh = init_params("flownet2", seed=0)
    with torch.device("meta"):
        net = FlowNet2()
    net = load_into(net, load_params(args.init_from) if args.init_from else fresh).to(device)
    for stage in [s for s in args.reinit.split(",") if s]:
        sub = STAGE_SUBTREE[stage]
        getattr(net, sub).load_state_dict(
            state_dict_from_params({k[len(sub) + 1:]: v for k, v in fresh.items() if k.startswith(sub + "/")}))
        print(f"re-randomized sub-net {sub}", flush=True)

    init_epe = cascade_epe(net, batch)
    print(f"cascade EPE at random init: {init_epe:.4f}", flush=True)
    results = {"init_epe": init_epe, "stages": {}}

    # each stage's optimizer and gradients cover its sub-net alone; the
    # frozen upstream runs without autograd inside the stage loss
    for stage in stages:
        loss_fn = with_compute_dtype(LOSSES[STAGE_LOSS_KEY[stage]],
                                     torch.bfloat16 if args.dtype == "bfloat16" else None)
        sub = STAGE_SUBTREE[stage]
        # eps 1e-12: per-pixel-normalized objectives (the fusion stage trains
        # at mean-EPE scale) shrink gradient magnitudes ~1e5x against the
        # pixel-sum convention; a small eps keeps Adam's scale invariance
        solver = make_solver(net, loss_fn, lr=args.lr, iters=args.iters, cosine=True, device=device, eps=1e-12,
                             trainable=getattr(net, sub))
        lines = []

        def log(msg):
            print(msg, flush=True)
            lines.append(msg)

        it, t0 = 0, time.time()
        log(f"[{stage}] training {sub} for {args.iters} iters")
        first_loss = loss = None
        while it < args.iters:
            n = min(args.chunk, args.iters - it)
            for _ in range(n):
                step_loss, _ = solver.step(batch)
            loss = float(step_loss)
            first_loss = loss if first_loss is None else first_loss
            it += n
            rate = n / max(time.time() - t0, 1e-9)
            t0 = time.time()
            log(f"Iteration {it}, loss = {loss:.6f} ({rate:.2f} iter/s)")
        del solver
        stage_epe = cascade_epe(net, batch)
        log(f"[{stage}] done: loss {first_loss:.4f} -> {loss:.4f}; cascade EPE {stage_epe:.4f}")
        results["stages"][stage] = {"first_loss": first_loss, "final_loss": loss, "cascade_epe": stage_epe}
        with open(os.path.join(args.out, f"log_{stage}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    final_epe = cascade_epe(net, batch)
    results["final_epe"] = final_epe
    print(f"cascade EPE: {init_epe:.4f} (random init) -> {final_epe:.4f} after staged training", flush=True)

    save_params(os.path.join(args.out, "flownet2_staged.npz"), params_from_state_dict(net.state_dict()))
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"checkpoint + logs written under {args.out}", flush=True)
    return 0 if final_epe < init_epe * 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
