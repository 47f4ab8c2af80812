"""bfloat16 against float32 inference on trained weights (the JAX package's
flownet2_tpu/tools/diag/bf16_parity.py).

Runs the net in float32 and in bfloat16 through ``FlowRunner`` on the same
pairs and prints three lines: the float32 GT-EPE, the bfloat16 GT-EPE with
its difference, and the mean and largest divergence of the two flows.
Under random weights the divergence is large and says nothing: point it at
a trained checkpoint (``tools.overfit_cascade``'s ``flownet2_staged.npz``).

    python -m flownet2_tpu_torch.tools.diag.bf16_parity --weights W.npz
        [--model flownet2] (--pairs P.npz | --synth [--size 320x448])
        [--gpu N | --device cpu]

``--pairs``: an ``.npz`` with img0, img1 (N, H, W, 3) and flow (N, H, W, 2);
``--synth``: 8 pairs of ``tools.synth_dataset`` (seed 0) at ``--size``.
``--gpu N`` runs on ``cuda:N``; ``--device`` names a device instead (``cpu``
for tests). Without a card and without ``--device`` it exits with an error:
it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_pairs(args) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(img0, img1, flow) from ``--pairs`` or ``--synth``."""
    if args.pairs:
        d = np.load(args.pairs)
        return d["img0"], d["img1"], d["flow"]
    from flownet2_tpu_torch.tools.synth_dataset import make_sample

    h, w = (int(v) for v in args.size.split("x"))
    rng = np.random.default_rng(0)
    samples = [make_sample(rng, h, w) for _ in range(8)]
    img0 = np.stack([s[0] for s in samples]).astype(np.float32)
    img1 = np.stack([s[1] for s in samples]).astype(np.float32)
    return img0, img1, np.stack([s[2] for s in samples])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", required=True, help=".npz params (trained)")
    p.add_argument("--model", default="flownet2")
    p.add_argument("--pairs", help=".npz with img0/img1/flow arrays")
    p.add_argument("--synth", action="store_true", help="score on 8 generated synthetic pairs instead")
    p.add_argument("--size", default="320x448", help="HxW of the --synth pairs")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    args = p.parse_args(argv)
    if not (args.pairs or args.synth):
        p.error("need --pairs or --synth")

    from flownet2_tpu_torch.checkpoint import load_params
    from flownet2_tpu_torch.cli.run_flownet import device_from_args
    from flownet2_tpu_torch.inference import FlowRunner

    device = device_from_args(args)
    img0, img1, flow = load_pairs(args)
    params = load_params(args.weights)

    def score(dtype):
        pred = FlowRunner(args.model, params, device=device, dtype=dtype).batch(img0, img1)
        return pred, float(np.sqrt(((pred - flow) ** 2).sum(-1)).mean())

    pred32, epe32 = score(None)
    pred16, epe16 = score("bfloat16")
    div = np.sqrt(((pred16 - pred32) ** 2).sum(-1))
    print(f"f32  GT-EPE: {epe32:.4f}")
    print(f"bf16 GT-EPE: {epe16:.4f}   (delta {epe16 - epe32:+.4f})")
    print(f"bf16-vs-f32 flow divergence: mean {div.mean():.4f} px, max {div.max():.2f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
