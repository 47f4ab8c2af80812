"""eval-parity on PyTorch: EPE parity against reference outputs or ground
truth (the port of flownet2_tpu/cli/eval_parity.py, same flags and output).

  # our model vs reference-produced (or ground-truth) .flo files
  python -m flownet2_tpu_torch.cli.eval_parity --model flownet2 \\
      --weights FlowNet2_weights.caffemodel[.h5] --list pairs.txt \\
      [--dtype float32] [--out-dir flo_out/] [--gpu N | --device cpu]

  # comparison of two .flo directories/sets (no net, no device)
  python -m flownet2_tpu_torch.cli.eval_parity --flo-a ours/ --flo-b reference/

``pairs.txt`` lines: ``img0 img1 ref.flo`` — the reference's
run-flownet-many list format (scripts/run-flownet-many.py:20-30) with the
output column pointing at the flows to compare against. ``--weights``
takes a flat ``.npz``, a ``.caffemodel`` / ``.caffemodel.h5`` or
``random``. ``--warp`` is accepted for compatibility: both values take the
exact warp kernel. Without a card and without ``--device``, ``--list``
exits with an error.

Prints one JSON line: {"pairs", "mean_epe", "max_epe", "worst_file"} — the
mean is the mean-over-pairs of per-pair average endpoint error between our
prediction and the listed .flo.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _epe(a, b) -> float:
    import numpy as np

    if a.shape != b.shape:
        raise ValueError(f"flow shapes differ: {a.shape} vs {b.shape}")
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


def _summary(epes: list[tuple[float, str]]) -> dict:
    worst = max(epes) if epes else (0.0, "")
    return {
        "pairs": len(epes),
        "mean_epe": round(sum(e for e, _ in epes) / max(len(epes), 1), 6),
        "max_epe": round(worst[0], 6),
        "worst_file": os.path.basename(worst[1]),
    }


def compare_flo_sets(dir_a: str, dir_b: str) -> dict:
    from flownet2_tpu_torch.core.flow_io import read_flo

    if os.path.isdir(dir_a):
        names = sorted(n for n in os.listdir(dir_a) if n.endswith(".flo"))
        pairs = [(os.path.join(dir_a, n), os.path.join(dir_b, n)) for n in names]
    else:
        pairs = [(dir_a, dir_b)]
    return _summary([(_epe(read_flo(a), read_flo(b)), a) for a, b in pairs])


def run_model_parity(args) -> dict:
    from flownet2_tpu_torch.cli.run_flownet import device_from_args, load_weights, resolve_model_name
    from flownet2_tpu_torch.core.flow_io import read_flo, read_image, write_flo
    from flownet2_tpu_torch.inference import FlowRunner

    model = resolve_model_name(args.model)
    device = device_from_args(args)
    runner = FlowRunner(model, load_weights(args.weights, model), device=device, dtype=args.dtype)

    epes = []
    with open(args.list) as f:
        lines = [line.split() for line in f if line.strip()]
    for img0_p, img1_p, ref_p in lines:
        pred = runner(read_image(img0_p), read_image(img1_p))
        epes.append((_epe(pred, read_flo(ref_p)), ref_p))
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            write_flo(os.path.join(args.out_dir, os.path.basename(ref_p)), pred)
    return _summary(epes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", help="model name or deploy-template path")
    p.add_argument("--weights", help=".npz / .caffemodel / .caffemodel.h5 / 'random'")
    p.add_argument("--list", help="lines: img0 img1 ref.flo")
    p.add_argument("--flo-a", help="compare mode: .flo file or directory")
    p.add_argument("--flo-b", help="compare mode: .flo file or directory")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--warp", default="exact", choices=["exact", "fast"],
                   help="accepted for compatibility: both take the exact warp kernel")
    p.add_argument("--out-dir", help="also dump our predictions here as .flo")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    args = p.parse_args(argv)

    if args.flo_a and args.flo_b:
        result = compare_flo_sets(args.flo_a, args.flo_b)
    elif args.model and args.weights and args.list:
        result = run_model_parity(args)
    else:
        p.error("need either --flo-a/--flo-b or --model/--weights/--list")
    print(json.dumps(result))
    return 0 if result["pairs"] else 1


if __name__ == "__main__":
    sys.exit(main())
