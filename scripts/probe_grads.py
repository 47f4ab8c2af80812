#!/usr/bin/env python3
"""How far one float32 train step's gradients move on their own: the card
against the CPU, beside the CPU against itself on a moved input.

For the joint FlowNet2 loss and the FlowNetC-stage loss, on the first batch
of ``chip_smoke.py``'s loader (synthetic FlyingChairs-layout pairs at
448x320) and its seeded weights, computes every parameter's gradient four
ways:

- card: the CUDA kernels and cuDNN (deterministic algorithms, TF32 off),
  twice, to show the card repeats itself;
- CPU: the plain versions;
- CPU and card again with the second frame scaled by ``1 + DELTA``
  (DELTA = 1e-6), a move of the input about as small as float32 rounding.

and prints, for card vs CPU, CPU vs moved CPU and card vs moved card, the
relative L2 error of all tensors together, of the median tensor and of the
worst, and the tensors above 1e-3. A gradient fault on the card shows as
card-vs-CPU errors the moved CPU runs do not have; kinks of the net (leaky
ReLUs, warp tap boundaries) within float32 noise of their inputs show in
both, as errors of the same size. Writes every per-tensor error to
``--out`` as JSON.

    python3 scripts/probe_grads.py --out build/probe_grads.json   # one card

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its loader, weights and gradient helpers)

DELTA = 1e-6  # relative move of the second frame


def summary(e: dict) -> str:
    return (f"all {e['all']:.3g}, median {e['median']:.3g}, worst {e['worst_key']} {e['worst']:.3g}, "
            f"{e['above_1e-3']} of {e['tensors']} above 1e-3")


def probe(label: str, model: str, loss_fn, batch: dict) -> dict:
    moved = dict(batch, img1=batch["img1"] * (1 + DELTA))
    grads = {}
    for name, device, b in (("card", "cuda", batch), ("card again", "cuda", batch), ("card moved", "cuda", moved),
                            ("cpu", "cpu", batch), ("cpu moved", "cpu", moved)):
        t0 = time.perf_counter()
        loss, grads[name] = chip_smoke.loss_and_grads(model, chip_smoke.SEED, loss_fn, b, device)
        print(f"[probe] {label} {name}: loss {loss:.9g} ({time.perf_counter() - t0:.1f} s)", flush=True)
    out = {}
    for a, b in (("card", "cpu"), ("card", "card again"), ("cpu", "cpu moved"), ("card", "card moved")):
        e = chip_smoke.grad_errors(grads[a], grads[b])
        out[f"{a} vs {b}"] = e
        print(f"[probe] {label} {a} vs {b}: {summary(e)}")
    per = {k: out[k]["per_tensor"] for k in out}
    flagged = sorted(per["card vs cpu"], key=per["card vs cpu"].get, reverse=True)[:8]
    print(f"[probe] {label}: the 8 worst tensors card vs CPU, beside CPU vs moved CPU and card vs moved card:")
    for k in flagged:
        print(f"[probe]   {k}: {per['card vs cpu'][k]:.3g} | {per['cpu vs cpu moved'][k]:.3g} | "
              f"{per['card vs card moved'][k]:.3g}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None, help="write the per-tensor errors here as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_grads: needs a CUDA card")
    from flownet2_tpu_torch.data import BatchLoader, FlyingChairs
    from flownet2_tpu_torch.train.objectives import flownet2_loss, flownet_c_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="probe_grads_chairs_")
    try:
        chip_smoke.write_chairs(tmp, 16)
        loader = iter(BatchLoader(FlyingChairs(tmp), chip_smoke.N, crop=(chip_smoke.H, chip_smoke.W),
                                  shuffle_seed=chip_smoke.SEED, num_threads=1))
        batch = next(loader)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results = {label: probe(label, model, loss_fn, batch)
               for label, model, loss_fn in (("flownetc", "flownetc", flownet_c_loss),
                                             ("joint", "flownet2", flownet2_loss))}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"delta": DELTA, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
