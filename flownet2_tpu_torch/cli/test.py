"""test on PyTorch: score a net over a dataset (the ``caffe test`` brew
command, tools/caffe.cpp:229-300). Metric: average EPE (+ per-batch log), the
FlowNet evaluation convention.

Flag-compatible with flownet2_tpu/cli/test.py:

    python -m flownet2_tpu_torch.cli.test --weights W --model M --data-root DIR
        [--dataset flyingchairs] [--iterations 0] [--batch 1]
        [--dtype float32|bfloat16] [--warp exact|fast] [--iters N] [--gpu N | --device cpu]

- ``--weights``: a flat ``.npz`` (a ``cli.train`` snapshot's or the JAX
  package's), a ``.caffemodel`` / ``.caffemodel.h5``, or ``random`` (seed 0);
- the batches come in file order, one epoch; each is run through
  ``FlowRunner`` (each model's input rule: the FlowNet models' /64 adapt
  and resize back, RAFT's /8 padding and crop) and scored against its
  ground truth with ``ops/losses.epe`` (NaN pixels excluded). A dataset in
  the transport domain (int16 flow) is decoded first, so it scores as its
  float form does;
- ``--warp`` is accepted so existing command lines run; both values take
  the exact warp kernel (the Hopper warp has no window budget to screen);
- ``--iters``: RAFT's updates (default 32); other models refuse it;
- ``--gpu N`` runs on ``cuda:N``; ``--device`` names a device instead
  (``cpu`` for tests). Without a card and without ``--device`` the CLI
  exits with an error: it never falls back to the CPU.

Prints ``Batch i, EPE = x`` per batch, then
``Loss: average EPE over N batches = x``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Iterable, Optional


def score(runner, batches: Iterable[dict], *, iterations: int = 0, log: Callable[[str], None] = print) -> list[float]:
    """The EPE of each batch of ``batches`` (dicts of NHWC arrays: img0,
    img1, flow) under ``runner``, logged as ``Batch i, EPE = x``; at most
    ``iterations`` batches when it is above 0."""
    import torch

    from flownet2_tpu_torch.core.codec import flow_as_f32
    from flownet2_tpu_torch.models.common import to_nchw
    from flownet2_tpu_torch.ops.losses import epe

    epes = []
    for i, batch in enumerate(batches):
        if iterations and i >= iterations:
            break
        img0, img1 = (torch.as_tensor(batch[k], device=runner.device).float() for k in ("img0", "img1"))
        gt = flow_as_f32(torch.as_tensor(batch["flow"], device=runner.device))
        e = float(epe(to_nchw(runner.run(img0, img1)), to_nchw(gt)))
        epes.append(e)
        log(f"Batch {i}, EPE = {e:.4f}")
    return epes


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", required=True, help=".npz params, .caffemodel[.h5] or 'random'")
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", default="flyingchairs")
    p.add_argument("--data-root", required=True)
    p.add_argument("--iterations", type=int, default=0, help="0 = full dataset")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"], help="compute dtype")
    p.add_argument("--warp", default="exact", choices=["exact", "fast"],
                   help="accepted for compatibility: both take the exact warp kernel")
    p.add_argument("--iters", type=int, default=None, help="RAFT's updates (default 32); raft only")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    return p


def main(argv=None, *, net_hook: Optional[Callable] = None) -> int:
    """The CLI. ``net_hook``, for scripts (no flag sets it): called with the
    runner's net before scoring (a diagnostic arm such as
    ``tools/diag/tpu_arith.route_convs``)."""
    args = build_parser().parse_args(argv)

    from flownet2_tpu_torch.cli.run_flownet import device_from_args, load_weights, resolve_model_name, runner_from_args
    from flownet2_tpu_torch.data import BatchLoader, open_dataset

    model = resolve_model_name(args.model)
    device = device_from_args(args)
    runner = runner_from_args(args, model, load_weights(args.weights, model), device)
    if net_hook is not None:
        net_hook(runner.net)
    dataset = open_dataset(args.dataset, args.data_root)
    # one worker thread: the batches come in file order, as "Batch i" says
    loader = BatchLoader(dataset, args.batch, shuffle_seed=None, epochs=1, num_threads=1)
    epes = score(runner, loader, iterations=args.iterations)
    if not epes:
        raise SystemExit("no batches evaluated")
    print(f"Loss: average EPE over {len(epes)} batches = {sum(epes) / len(epes):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
