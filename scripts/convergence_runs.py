#!/usr/bin/env python3
"""Convergence runs of the PyTorch port on one CUDA card: does training make
the nets better?

- ``r5``: the recipe of runs/synth/run_r5.sh with the port's CLIs:
  tools.synth_dataset writes 2048 training and 64 held-out samples at
  384x512 (seed 11); cli.train trains FlowNetS on them (320x448 crops,
  augmented, batch 8, S_short, Adam at 2e-4, snapshots every 1504
  iterations) once for each of ``--train-seeds`` (default 3, the JAX run's
  seed: it seeds the weights, the sample order and the augmentation);
  cli.test scores the held-out split at initialisation (``random``, seed 0)
  and at every snapshot. ``--r5-pipeline cache`` (the default) trains as
  run_r5.sh does, from the device cache (``--device-cache 256 --cache-slab
  64 --steps-per-dispatch 32``); ``--r5-min-echo E`` sets the cache's echo
  throttle (a swap after 64 * E draws; default the cache's 0.25): 16 swaps
  a slab every 4 chunks, about 24 swaps by 3008 iterations, the JAX run's
  turnover (48 swaps in 6016, runs/synth/log_train.txt). ``--r5-pipeline
  loader`` feeds cli.train from BatchLoader, each sample once an epoch;
  ``--split PREFIX`` keeps the split at PREFIX (and reuses one found
  there) instead of a temporary directory;
- ``overfit``: tools.overfit for ``--overfit-iters`` iterations (cosine
  decay) in float32 and in bfloat16 on 8 synthetic FlyingChairs-layout
  pairs (synth_dataset's default settings, 384x512), against its 0.5
  criterion at the supervised 1/4 resolution;
- ``cascade``: tools.overfit_cascade through c, s1, s2, sd and fusion on the
  same pairs, the cascade EPE after each stage.

The training split is written in a separate process while the overfit and
cascade runs use the card. Each tool's own output goes to
``OUT/<run>.log``; the results go to ``OUT/convergence.json`` and, one line
each, to standard output, with the card's name and power limit.

    python3 scripts/convergence_runs.py [--out build/convergence] [--runs r5,overfit,cascade]
        [--r5-iters 3008] [--train-seeds 3[,5,...]] [--r5-pipeline cache|loader] [--r5-min-echo E]
        [--split PREFIX] [--overfit-iters 2000] [--cascade-iters 800]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# cli.train with device-cache constructor options (JSON in argv[1]), which
# no flag of the CLI sets
TRAIN_WITH_OPTIONS = ("import json, sys; from flownet2_tpu_torch.cli.train import main; "
                      "sys.exit(main(sys.argv[2:], cache_options=json.loads(sys.argv[1])))")


def run(cmd: list, log_path: str, timeout: float) -> tuple[int, str, float]:
    """Run ``cmd`` from the repository root; (exit code, its output, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode not in (0, 1):  # the tools exit 1 when a criterion is missed
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def write_pairs(root: str, n: int = 8, seed: int = 0) -> None:
    """n FlyingChairs-layout pairs at 384x512, synth_dataset's default settings."""
    import numpy as np

    from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
    from flownet2_tpu_torch.tools.synth_dataset import make_sample

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img0, img1, flow = make_sample(rng)
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), img0)
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"), img1)
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), flow)


def heldout_epe(weights: str, eval_rec: str, log_path: str) -> float:
    rc, out, _ = run([sys.executable, "-m", "flownet2_tpu_torch.cli.test", "--weights", weights, "--model", "flownets",
                      "--dataset", "flowrec", "--data-root", eval_rec, "--batch", "4", "--gpu", "0"], log_path, 600)
    if rc != 0:
        raise RuntimeError(f"cli.test {weights}: exit {rc}")
    return float([line for line in out.splitlines() if line.startswith("Loss:")][-1].rsplit("=", 1)[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="build/convergence")
    p.add_argument("--runs", default="r5,overfit,cascade")
    p.add_argument("--r5-iters", type=int, default=3008)
    p.add_argument("--train-seeds", default="3", help="comma list: one r5 training run per seed")
    p.add_argument("--r5-pipeline", default="cache", choices=("cache", "loader"),
                   help="cache: run_r5.sh's device cache and 32 steps a dispatch; loader: BatchLoader")
    p.add_argument("--r5-min-echo", type=float, default=None,
                   help="the device cache's min_echo (default the cache's own); 16: the JAX run's turnover")
    p.add_argument("--split", default=None, help="keep the r5 split at this prefix, reusing one found there")
    p.add_argument("--overfit-iters", type=int, default=2000)
    p.add_argument("--cascade-iters", type=int, default=800)
    args = p.parse_args(argv)
    runs = args.runs.split(",")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("convergence_runs: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[convergence] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    data = tempfile.mkdtemp(prefix="convergence_")  # the samples and snapshots stay out of OUT
    results = {"card": card}

    def save():
        with open(os.path.join(out, "convergence.json"), "w") as f:
            json.dump(results, f, indent=1)

    gen = None
    prefix = os.path.abspath(args.split) if args.split else os.path.join(data, "synth")
    have_split = all(os.path.exists(prefix + f"_{part}.flowrec") for part in ("train", "eval"))
    if "r5" in runs and not have_split:  # the CPU writes the 2048 samples while the card runs the rest
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        gen = subprocess.Popen([sys.executable, "-m", "flownet2_tpu_torch.tools.synth_dataset", "--n", "2048",
                                "--n-eval", "64", "--out", prefix, "--seed", "11"], cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t_gen = time.perf_counter()
    try:
        pairs = os.path.join(data, "pairs")
        if "overfit" in runs or "cascade" in runs:
            write_pairs(pairs)
        if "overfit" in runs:
            for dtype in ("float32", "bfloat16"):
                rc, text, secs = run([sys.executable, "-m", "flownet2_tpu_torch.tools.overfit", "--data", pairs,
                                      "--iters", str(args.overfit_iters), "--cosine", "--dtype", dtype,
                                      "--log", os.path.join(out, f"overfit_{dtype}_solver.log"), "--gpu", "0"],
                                     os.path.join(out, f"overfit_{dtype}.log"), 3000)
                last = text.strip().splitlines()[-1]
                full, quarter = float(last.split(":")[1].split()[0]), float(last.split(";")[1].split()[0])
                first = float(text.splitlines()[0].rsplit("=", 1)[1])
                results[f"overfit_{dtype}"] = dict(iters=args.overfit_iters, exit=rc, full_res_epe_start=first,
                                                   full_res_epe=full, quarter_epe=quarter, criterion=0.5,
                                                   met=quarter < 0.5, seconds=secs)
                print(f"[convergence] overfit {dtype} {args.overfit_iters} iterations: {last} (exit {rc}, "
                      f"{secs:.1f} s; full-res EPE at start {first}) ({card})", flush=True)
                save()
        if "cascade" in runs:
            casc = os.path.join(data, "cascade")  # its 650 MB .npz stays on the card's machine
            rc, text, secs = run([sys.executable, "-m", "flownet2_tpu_torch.tools.overfit_cascade", "--data", pairs,
                                  "--iters", str(args.cascade_iters), "--out", casc, "--gpu", "0"],
                                 os.path.join(out, "cascade.log"), 3000)
            with open(os.path.join(casc, "results.json")) as f:
                results["cascade"] = dict(json.load(f), iters=args.cascade_iters, exit=rc, seconds=secs)
            for name in os.listdir(casc):
                if name.startswith("log_"):
                    shutil.copy(os.path.join(casc, name), os.path.join(out, f"cascade_{name}"))
            print(f"[convergence] overfit_cascade {args.cascade_iters} iterations a stage: "
                  f"{text.strip().splitlines()[-2]} (exit {rc}, {secs:.1f} s) ({card})", flush=True)
            save()
        if "r5" in runs and gen is not None:
            gen_out = gen.communicate(timeout=3600)[0]
            if gen.returncode != 0:
                raise RuntimeError(f"synth_dataset: exit {gen.returncode}\n{gen_out[-2000:]}")
            print(f"[convergence] synth_dataset 2048 + 64 samples: {time.perf_counter() - t_gen:.1f} s", flush=True)
        if "r5" in runs:
            init = heldout_epe("random", prefix + "_eval.flowrec", os.path.join(out, "r5_eval_init.log"))
            runs_out = []
            pipeline = args.r5_pipeline
            if pipeline == "cache":
                pipeline += f", min_echo {args.r5_min_echo if args.r5_min_echo is not None else 'default'}"
            tag = args.r5_pipeline + ("" if args.r5_min_echo is None else f"_echo{args.r5_min_echo:g}")
            for seed in (int(v) for v in args.train_seeds.split(",")):
                snaps = os.path.join(data, f"snaps_{tag}_seed{seed}")
                cli = ["--model", "flownets", "--dataset", "flowrec", "--data-root", prefix + "_train.flowrec",
                       "--crop", "320x448", "--batch", "8", "--max-iter", str(args.r5_iters), "--schedule", "S_short",
                       "--solver", "adam", "--base-lr", "2e-4", "--display", "96", "--snapshot-dir", snaps,
                       "--snapshot-interval", "1504", "--seed", str(seed), "--gpu", "0"]
                if args.r5_pipeline == "cache":
                    cli += ["--device-cache", "256", "--cache-slab", "64", "--steps-per-dispatch", "32"]
                options = {} if args.r5_min_echo is None else {"min_echo": args.r5_min_echo}
                rc, text, secs = run([sys.executable, "-u", "-c", TRAIN_WITH_OPTIONS, json.dumps(options), *cli],
                                     os.path.join(out, f"r5_train_{tag}_seed{seed}.log"), 3600)
                if rc != 0:
                    raise RuntimeError(f"cli.train seed {seed}: exit {rc}")
                cache_line = next((line for line in text.splitlines() if line.startswith("Device cache:")), None)
                curve = [dict(iteration=0, weights="random-init", epe=init)]
                for name in sorted(n for n in os.listdir(snaps) if n.endswith(".npz")):
                    it = int(name.split("_")[1].split(".")[0])
                    curve.append(dict(iteration=it, weights=name, epe=heldout_epe(
                        os.path.join(snaps, name), prefix + "_eval.flowrec",
                        os.path.join(out, f"r5_eval_{tag}_seed{seed}_{it:07d}.log"))))
                runs_out.append(dict(seed=seed, pipeline=pipeline, train_seconds=secs, cache=cache_line, curve=curve))
                print(f"[convergence] r5 recipe ({pipeline}), training seed {seed}, held-out mean EPE: "
                      f"{', '.join(f'{c['iteration']}: {c['epe']:.4f}' for c in curve)} (JAX TPU run, seed 3: "
                      f"24.70 / 12.07 / 8.51); {cache_line or 'no device cache'}; cli.train {secs:.1f} s ({card})",
                      flush=True)
                results["r5"] = dict(train_samples=2048, eval_samples=64, resolution="384x512", crop="320x448",
                                     pipeline=pipeline, runs=runs_out,
                                     jax_curve={"0": 24.6989, "1504": 12.0651, "3008": 8.5095},
                                     jax_cache="Device cache: 48 slab refreshes, 3328 samples uploaded (6543 MB) "
                                     "in 6016 iterations")
                save()
            finals = [r["curve"][-1]["epe"] for r in runs_out]
            print(f"[convergence] r5 recipe ({pipeline}), held-out mean EPE at {args.r5_iters} over seeds "
                  f"{args.train_seeds}: {', '.join(f'{v:.4f}' for v in finals)} (min {min(finals):.4f}, max "
                  f"{max(finals):.4f}; JAX TPU run 8.5095) ({card})", flush=True)
            save()
    finally:
        if gen is not None and gen.poll() is None:
            gen.kill()
            gen.wait()
        shutil.rmtree(data, ignore_errors=True)
    save()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
