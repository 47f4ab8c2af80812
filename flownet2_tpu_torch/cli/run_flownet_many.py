"""run-flownet-many on PyTorch: list-file batch inference.

Argument-compatible with flownet2_tpu/cli/run_flownet_many.py (and the
reference scripts/run-flownet-many.py):

    python -m flownet2_tpu_torch.cli.run_flownet_many <weights> <model> <listfile>
        [--gpu N] [--device DEV] [--dtype float32|bfloat16] [--iters N] [--verbose]

- ``listfile``: one job per line, ``img0 img1 out.flo``; blank lines are
  skipped. Every input is checked before the first job runs;
- one ``FlowRunner`` serves every job, whatever its resolution (PyTorch runs
  eagerly, so nothing is rebuilt when the resolution changes);
- ``weights``, ``model``, ``--gpu``, ``--device``, ``--dtype`` and ``--iters``
  as in ``run_flownet``. Without a card and without ``--device``, it exits with
  an error: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def read_jobs(listfile: str) -> list[list[str]]:
    """The list file's ``img0 img1 out.flo`` triples; exits on a malformed
    line or a missing input."""
    if not os.path.exists(listfile):
        raise SystemExit(f"list file does not exist: {listfile}")
    jobs = []
    with open(listfile) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise SystemExit(f"{listfile}:{ln}: expected 'img0 img1 out.flo'")
            jobs.append(parts)
    for img0, img1, _ in jobs:
        for path in (img0, img1):
            if not os.path.exists(path):
                raise SystemExit(f"input does not exist: {path}")
    return jobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("caffemodel", help="path to weights (.caffemodel, .caffemodel.h5 or .npz) or 'random'")
    p.add_argument("deployproto", help="model name or deploy template path")
    p.add_argument("listfile", help="one line per job: img0 img1 out.flo")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    p.add_argument("--verbose", action="store_true", help="accepted for compatibility; no effect")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"], help="compute dtype")
    p.add_argument("--iters", type=int, default=None, help="RAFT's updates (default 32); raft only")
    args = p.parse_args(argv)
    if args.caffemodel != "random" and not os.path.exists(args.caffemodel):
        raise SystemExit(f"input does not exist: {args.caffemodel}")
    jobs = read_jobs(args.listfile)

    from flownet2_tpu_torch.cli.run_flownet import device_from_args, load_weights, resolve_model_name, runner_from_args
    from flownet2_tpu_torch.core.flow_io import read_image, write_flo

    model = resolve_model_name(args.deployproto)
    device = device_from_args(args)
    runner = runner_from_args(args, model, load_weights(args.caffemodel, model), device)
    for i, (img0, img1, out) in enumerate(jobs):
        write_flo(out, runner(read_image(img0), read_image(img1)))
        print(f"[{i + 1}/{len(jobs)}] {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
