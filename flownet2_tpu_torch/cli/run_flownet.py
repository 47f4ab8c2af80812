"""run-flownet on PyTorch: single image-pair inference.

Argument-compatible with flownet2_tpu/cli/run_flownet.py (and the reference
scripts/run-flownet.py):

    python -m flownet2_tpu_torch.cli.run_flownet <weights> <model> <img0> <img1> <out>
        [--gpu N] [--device DEV] [--dtype float32|bfloat16] [--iters N] [--verbose]

- ``weights``: the reference's Caffe weights (``.caffemodel`` binaryproto or
  ``.caffemodel.h5``, imported by ``models.import_caffe``), a flat ``.npz``
  in the JAX package's layout (``checkpoint.save_params``), or ``random``
  for seeded random weights (seed 0: the JAX CLI's ``random``, bit for bit);
- ``model``: flownets|flownetc|flownet2-sd|flownet2-cs|flownet2-css|flownet2|dispnetc|raft,
  or a deploy-template path whose basename names one. ``raft`` takes ``random``
  or an ``.npz`` (there is no Caffe RAFT) and ``--iters``, its updates
  (default 32, its Sintel evaluation's); other models refuse ``--iters``;
- ``--gpu N`` runs on ``cuda:N``; ``--device`` names a device instead (``cpu``
  for tests). Without a card and without ``--device``, the CLI exits with
  an error: it never falls back to the CPU;
- output: a ``.flo`` file ("PIEH", w, h, float32 HWC).
"""

from __future__ import annotations

import argparse
import os
import sys


def resolve_model_name(spec: str) -> str:
    from flownet2_tpu_torch.inference import MODEL_NAMES

    base = os.path.basename(spec).lower().replace("_", "-").replace(".", "-")
    if spec.lower() in MODEL_NAMES:
        return spec.lower()
    # longest pattern first, so the most specific reference template name
    # wins (FlowNet2-CSS-ft-sd over FlowNet2-CSS over FlowNet2-CS, ...)
    table = {name: name for name in MODEL_NAMES}
    table.update(
        {
            "flownet2-s": "flownets",
            "flownet2-c": "flownetc",
            "flownet2-css-ft-sd": "flownet2-css",
            "flownet2-kitti": "flownet2",
            "flownet2-sintel": "flownet2",
        }
    )
    for pattern in sorted(table, key=len, reverse=True):
        if pattern in base:
            return table[pattern]
    raise SystemExit(f"cannot infer model from {spec!r}; known: {MODEL_NAMES}")


def load_weights(path: str, model: str) -> dict:
    from flownet2_tpu_torch.checkpoint import load_params
    from flownet2_tpu_torch.inference import MODEL_INITS

    if path == "random":
        return MODEL_INITS[model](seed=0)
    if path.endswith((".caffemodel", ".h5")):
        from flownet2_tpu_torch.models.import_caffe import import_caffemodel

        try:
            return import_caffemodel(path, model)
        except ValueError as e:
            raise SystemExit(f"{path}: {e}") from None
    return load_params(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("caffemodel", help="path to weights (.caffemodel, .caffemodel.h5 or .npz) or 'random'")
    p.add_argument("deployproto", help="model name or deploy template path")
    p.add_argument("img0", help="image 0 path")
    p.add_argument("img1", help="image 1 path")
    p.add_argument("out", help="output .flo filename")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    p.add_argument("--verbose", action="store_true", help="accepted for compatibility; no effect")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"], help="compute dtype")
    p.add_argument("--iters", type=int, default=None, help="RAFT's updates (default 32); raft only")
    return p


def runner_from_args(args, model: str, weights: dict, device: str):
    """The ``FlowRunner`` the options ask for; exits with its message on an
    option the model refuses (``--iters`` on a FlowNet model)."""
    from flownet2_tpu_torch.inference import FlowRunner

    try:
        return FlowRunner(model, weights, device=device, dtype=args.dtype, iters=args.iters)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def device_from_args(args) -> str:
    if args.device is not None:
        return args.device
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --device cpu to run on the CPU")
    if args.gpu >= torch.cuda.device_count():
        raise SystemExit(f"device {args.gpu} not available ({torch.cuda.device_count()} present)")
    return f"cuda:{args.gpu}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for f in (args.caffemodel, args.img0, args.img1):
        if f != "random" and not os.path.exists(f):
            raise SystemExit(f"input does not exist: {f}")

    from flownet2_tpu_torch.core.flow_io import read_image, write_flo

    model = resolve_model_name(args.deployproto)
    device = device_from_args(args)
    runner = runner_from_args(args, model, load_weights(args.caffemodel, model), device)
    img0 = read_image(args.img0)
    img1 = read_image(args.img1)
    print(f"Network forward pass using {args.caffemodel} on {device}.")
    write_flo(args.out, runner(img0, img1))
    print("Succeeded.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
