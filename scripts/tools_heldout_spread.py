#!/usr/bin/env python3
"""The spread of chip_smoke.py [tools]' held-out check on one CUDA card.

The check trains FlowNetC with cli.train (1000 iterations, 320x448 crops
of 48 synthetic 384x512 samples, augmented, batch 8, S_short, Adam at
2e-4, seed 0) and asks cli.test for a held-out mean EPE on 8 other samples
below 0.6 times the initial weights'. A seed does not repeat on the card,
so the ratio varies from run to run. This script repeats the check's
train-and-score part ``--runs`` times on the same data, in turns fed as
cli.train feeds (through ``DevicePrefetcher``) and fed the loader's host
batches directly, as before the prefetcher, and prints per run the feed,
the display losses, the held-out EPE, the ratio and the EPE of each
held-out sample; then the ratios' mean and sample SD and whether the check
is steady: every ratio below 0.6 and the mean plus 2 SD below 0.6. It
imports chip_smoke.py's helpers and settings (cuDNN's TF32 off, as there).

    python3 scripts/tools_heldout_spread.py [--runs 8] [--out build/tools_spread.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIMIT = 0.6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=8, help="train-and-score runs, the two feeds in turns")
    p.add_argument("--out", default=None, help="write the results here as JSON")
    args = p.parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="tools_spread_")
    try:
        results = spread(args.runs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def spread(n_runs: int, tmp: str) -> dict:
    """The check's data in the folder ``tmp``, then ``n_runs`` runs."""
    import torch

    import chip_smoke as cs
    import flownet2_tpu_torch.data as data
    from flownet2_tpu_torch.cli import test as test_cli
    from flownet2_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from flownet2_tpu_torch.ops.warp import flow_warp_backward_cuda, flow_warp_cuda
    from flownet2_tpu_torch.tools.synth_dataset import write_split

    _, card = cs.phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    counters = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)
    prefetcher = data.DevicePrefetcher
    train_rec, eval_rec = os.path.join(tmp, "train.flowrec"), os.path.join(tmp, "eval.flowrec")
    kw = dict(max_shift=5.0, n_layers=2, log=lambda *_: None)
    write_split(train_rec, 48, 11, *cs.CHAIRS_FRAME, **kw)
    write_split(eval_rec, 8, 11 + 999_983, *cs.CHAIRS_FRAME, **kw)

    def score(weights: str, batch: int) -> tuple[float, list[float]]:
        rc, out = cs.main_in_process(test_cli.main, ["--weights", weights, "--model", "flownetc", "--dataset",
                                                     "flowrec", "--data-root", eval_rec, "--batch", str(batch),
                                                     "--gpu", "0"])
        cs.check(rc == 0, f"cli.test {weights}: exit {rc}")
        return cs.last_float(out, "Loss:"), [float(line.rsplit("=", 1)[1]) for line in out.splitlines()
                                             if line.startswith("Batch ")]

    initial, initial_each = score("random", 1)
    print(f"[spread] initial held-out EPE {initial:.4f}; per sample {', '.join(f'{v:.3f}' for v in initial_each)} "
          f"({card})", flush=True)
    iters = cs.TOOLS_TRAIN_ITERS
    runs = []
    for i in range(n_runs):
        feed = ("prefetcher", "direct")[i % 2]
        snaps = os.path.join(tmp, f"snaps{i}")
        argv = ["--model", "flownetc", "--dataset", "flowrec", "--data-root", train_rec, "--batch", str(cs.N),
                "--crop", f"{cs.H}x{cs.W}", "--max-iter", str(iters), "--schedule", "S_short", "--base-lr", "2e-4",
                "--seed", "0", "--display", str(iters // 4), "--snapshot-dir", snaps, "--snapshot-interval", "0",
                "--gpu", "0"]
        if feed == "direct":  # cli.train's loop gets the loader's host batches; Solver.step uploads them
            data.DevicePrefetcher = lambda batches, device=None, depth=2: batches
        t0 = time.perf_counter()
        try:
            out, launches = cs.train_cli_in_process(argv, counters)
        finally:
            data.DevicePrefetcher = prefetcher
        secs = time.perf_counter() - t0
        weights = os.path.join(snaps, f"iter_{iters:07d}.npz")
        trained, _ = score(weights, 4)  # the check's own batch
        _, each = score(weights, 1)
        losses = [line for line in out.splitlines() if line.startswith("Iteration")]
        runs.append(dict(feed=feed, trained=trained, ratio=trained / initial, per_sample=each, losses=losses,
                         launches=launches, seconds=secs))
        print(f"[spread] run {i + 1} ({feed}): EPE {trained:.4f}, ratio {trained / initial:.4f}; per sample "
              f"{', '.join(f'{v:.3f}' for v in each)}; launches (K1, K2, corr, corr bwd) {launches}; {secs:.1f} s; "
              f"{'; '.join(losses)}", flush=True)
    ratios = [r["ratio"] for r in runs]
    mean, sd = statistics.mean(ratios), statistics.stdev(ratios) if len(ratios) > 1 else 0.0
    steady = max(ratios) < LIMIT and mean + 2 * sd < LIMIT
    by_feed = {f: [r["ratio"] for r in runs if r["feed"] == f] for f in ("prefetcher", "direct")}
    print(f"[spread] ratios {', '.join(f'{v:.4f}' for v in ratios)}; mean {mean:.4f}, sample sd {sd:.4f}, "
          f"mean + 2 sd {mean + 2 * sd:.4f} (limit {LIMIT}): {'steady' if steady else 'NOT steady'}; "
          + "; ".join(f"{f} {statistics.mean(v):.4f}" for f, v in by_feed.items() if v) + f" ({card})", flush=True)
    return dict(card=card, initial=initial, initial_per_sample=initial_each, runs=runs, mean=mean, sd=sd,
                steady=steady)


if __name__ == "__main__":
    sys.exit(main())
