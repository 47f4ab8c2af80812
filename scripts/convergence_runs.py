#!/usr/bin/env python3
"""Convergence runs of the PyTorch port on one CUDA card: does training make
the nets better?

- ``r5``: the recipe of runs/synth/run_r5.sh with the port's CLIs:
  tools.synth_dataset writes 2048 training and 64 held-out samples at
  384x512 (seed 11); cli.train trains FlowNetS on them (320x448 crops,
  augmented, batch 8, S_short, Adam at 2e-4, 6016 iterations, snapshots
  every 1504) once for each of ``--train-seeds`` (default 3, the JAX run's
  seed: it seeds the weights, the sample order and the augmentation);
  cli.test scores the held-out split at initialisation (``random``, seed 0)
  and at every snapshot. Each run prints its held-out EPEs, the mean of its
  display losses over iterations 1536-3008 and 3104-6016, and the TF32
  flags its training process ran under; the JAX run's figures
  (runs/synth/log_train.txt, runs/synth/epe_curve.json) stand beside them,
  and with two seeds or more at 6016 iterations the script applies the
  decision rule of PERF.md (``r5_decision``). ``--r5-pipeline cache`` (the
  default) trains as run_r5.sh does, from the device cache
  (``--device-cache 256 --cache-slab 64 --steps-per-dispatch 32``);
  ``--r5-min-echo E`` sets the cache's echo throttle (a swap after 64 * E
  draws; default the cache's 0.25): 16 swaps a slab every 4 chunks, 47
  swaps in 6016 iterations, the JAX run's turnover (48 swaps in 6016,
  runs/synth/log_train.txt). ``--r5-pipeline
  loader`` feeds cli.train from BatchLoader, each sample once an epoch;
  ``--split PREFIX`` keeps the split at PREFIX (and reuses one found
  there) instead of a temporary directory; ``--r5-exact-f32`` trains with
  cuDNN's TF32 off (exact float32, as the reference and the JAX package's
  CPU route compute; the CLIs keep PyTorch's default, TF32 convolutions);
- ``overfit``: tools.overfit for ``--overfit-iters`` iterations (cosine
  decay) in float32 and in bfloat16 on 8 synthetic FlyingChairs-layout
  pairs (synth_dataset's default settings, 384x512), against its 0.5
  criterion at the supervised 1/4 resolution;
- ``cascade``: tools.overfit_cascade through c, s1, s2, sd and fusion from
  ``init_params("flownet2", seed=0)`` on the 8 pairs of chip_smoke.py's
  [tools] phase (384x512, seed 50, two layers, shifts up to 5 px), trained
  at 448x320 as the JAX run took it (runs/cascade/log_*.txt): c, s1, s2 and
  sd for ``--cascade-iters`` each in one invocation, then fusion for
  ``--cascade-fusion-iters`` (default the same) ``--init-from`` its .npz.
  The cascade EPE and seconds of each stage, then tools.diag.bf16_parity
  on the trained weights and the same pairs (f32 and bf16 GT-EPE).

``--decide A.json[,B.json...]`` trains nothing and needs no card: it pools
the r5 runs of earlier invocations' convergence.json files by arm (the TF32
flags each trained under) and applies PERF.md's rules to them: rules (a)
and (b) to the default arm and, when the gap stays open, the precision rule
(``precision_decision``) to the two arms.

The training split is written in a separate process while the overfit and
cascade runs use the card. Each tool's own output goes to
``OUT/<run>.log``; the results go to ``OUT/convergence.json`` and, one line
each, to standard output, with the card's name and power limit.

    python3 scripts/convergence_runs.py [--out build/convergence] [--runs r5,overfit,cascade]
        [--r5-iters 6016] [--train-seeds 3[,5,...]] [--r5-pipeline cache|loader] [--r5-min-echo E]
        [--split PREFIX] [--r5-exact-f32] [--overfit-iters 2000] [--cascade-iters 800]
        [--cascade-fusion-iters F]
    python3 scripts/convergence_runs.py --decide A/convergence.json,B/convergence.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# cli.train with device-cache constructor options (JSON in argv[1]), which
# no flag of the CLI sets; its last line is the TF32 flags it trained under
# ("exact_f32": true in the JSON turns cuDNN's TF32 off before main)
TRAIN_WITH_OPTIONS = ("import json, sys, torch; from flownet2_tpu_torch.cli.train import main\n"
                      "options = json.loads(sys.argv[1])\n"
                      "if options.pop('exact_f32', False):\n"
                      "    torch.backends.cudnn.allow_tf32 = False\n"
                      "rc = main(sys.argv[2:], cache_options=options)\n"
                      "print('TF32: cudnn', torch.backends.cudnn.allow_tf32, 'matmul', "
                      "torch.backends.cuda.matmul.allow_tf32); sys.exit(rc)")
JAX_R5 = os.path.join(ROOT, "runs", "synth")  # run_r5.sh's outputs on the TPU
HELD_OUT = (3008, 4512, 6016)  # the snapshots whose mean EPE the decision rule compares
LOSS_WINDOWS = ((1536, 3008), (3104, 6016))


def run(cmd: list, log_path: str, timeout: float) -> tuple[int, str, float]:
    """Run ``cmd`` from the repository root; (exit code, its output, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode not in (0, 1):  # the tools exit 1 when a criterion is missed
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def write_pairs(root: str, n: int = 8, seed: int = 0, **settings) -> None:
    """n FlyingChairs-layout pairs at 384x512 (synth_dataset's default
    settings, or ``make_sample``'s keyword ``settings``)."""
    import numpy as np

    from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
    from flownet2_tpu_torch.tools.synth_dataset import make_sample

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img0, img1, flow = make_sample(rng, **settings)
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), img0)
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"), img1)
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), flow)


def display_losses(text: str) -> dict[int, float]:
    """iteration -> display loss of a training log, up to its first
    "Optimization done" (the JAX log goes on with a resumed run)."""
    text = text.split("Optimization done")[0]
    return {int(it): float(v) for it, v in re.findall(r"^Iteration (\d+), loss = (\S+)", text, re.M)}


def loss_means(losses: dict[int, float]) -> list:
    """Mean display loss over each of LOSS_WINDOWS (None where it has no line)."""
    out = []
    for lo, hi in LOSS_WINDOWS:
        v = [x for it, x in losses.items() if lo <= it <= hi]
        out.append(sum(v) / len(v) if v else None)
    return out


def jax_r5() -> dict:
    """The JAX TPU run of run_r5.sh (seed 3): its held-out curve, display-loss
    means and cache line."""
    with open(os.path.join(JAX_R5, "epe_curve.json")) as f:
        curve = {c["iteration"]: c["epe"] for c in json.load(f)["curve"] if c["iteration"] <= 6016}
    with open(os.path.join(JAX_R5, "log_train.txt")) as f:
        text = f.read()
    cache = next(line for line in text.splitlines() if line.startswith("Device cache:"))
    return dict(curve=curve, loss_means=loss_means(display_losses(text)), cache=cache)


def r5_decision(port: list[dict], jax: dict) -> dict:
    """PERF.md's rule for the run_r5.sh gap: closed when (a) the JAX run's
    display-loss means over both windows lie within the port seeds' min-max
    and (b) its mean held-out EPE over 3008, 4512 and 6016 lies within 2
    sample standard deviations of the port seeds' mean of the same."""
    a = []
    for w in range(len(LOSS_WINDOWS)):
        v = [r["loss_means"][w] for r in port]
        a.append(dict(window=LOSS_WINDOWS[w], jax=jax["loss_means"][w], port_min=min(v), port_max=max(v),
                      within=min(v) <= jax["loss_means"][w] <= max(v)))
    held = [sum(r["epe"][it] for it in HELD_OUT) / len(HELD_OUT) for r in port]
    jax_held = sum(jax["curve"][it] for it in HELD_OUT) / len(HELD_OUT)
    mean, sd = statistics.mean(held), statistics.stdev(held)
    b = dict(jax=jax_held, port_means=held, port_mean=mean, port_sd=sd, z=(jax_held - mean) / sd,
             within=abs(jax_held - mean) <= 2 * sd)
    return dict(a=a, b=b, closed=all(x["within"] for x in a) and b["within"])


def precision_decision(default: list[dict], exact: list[dict], jax: dict) -> dict:
    """PERF.md's rule naming precision as the cause of the later-loss gap:
    the exact-float32 arm's mean display loss over 3104-6016 lies below the
    default (TF32) arm's by more than 2 standard errors of the difference
    (Welch), and the JAX run's mean over that window lies within the exact
    arm's min-max."""
    d, e = ([r["loss_means"][1] for r in runs] for runs in (default, exact))
    diff = statistics.mean(d) - statistics.mean(e)
    se = (statistics.variance(d) / len(d) + statistics.variance(e) / len(e)) ** 0.5
    jax_late = jax["loss_means"][1]
    below, covers = diff > 2 * se, min(e) <= jax_late <= max(e)
    return dict(default_mean=statistics.mean(d), exact_mean=statistics.mean(e), diff=diff, se=se, below=below,
                exact_min=min(e), exact_max=max(e), jax=jax_late, jax_within_exact=covers, named=below and covers)


def train_rate(log: str) -> float:
    """Iterations a second of a cli.train log over its display chunks after
    the first (which holds the start-up and cuDNN's algorithm search)."""
    rates = re.findall(r"^Iteration (\d+), loss = \S+ \((\S+) iter/s\)", log, re.M)
    its = [int(it) for it, _ in rates]
    secs = sum((b - a) / float(r) for a, b, (_, r) in zip(its, its[1:], rates[1:]))
    return (its[-1] - its[0]) / secs


def decide(paths: list[str]) -> int:
    """Pool the r5 runs of several convergence.json files by arm (the TF32
    flags each run trained under) and apply PERF.md's rules: r5_decision to
    the default arm and, with an exact-float32 arm, precision_decision."""
    arms: dict[str, list] = {"default": [], "exact": []}
    jax = None
    for path in paths:
        with open(path) as f:
            r5 = json.load(f)["r5"]
        jax = r5["jax"]
        for r in r5["runs"]:
            arm = "exact" if "cudnn False" in r["tf32"] else "default"
            arms[arm].append(dict(seed=r["seed"], tf32=r["tf32"], loss_means=r["loss_means"],
                                  epe={c["iteration"]: c["epe"] for c in r["curve"]}, rate=r.get("iter_per_s")))
    jax = dict(jax, curve={int(k): v for k, v in jax["curve"].items()})
    for arm, runs in arms.items():
        for r in runs:
            held = sum(r["epe"][it] for it in HELD_OUT) / len(HELD_OUT)
            print(f"[decide] {arm} seed {r['seed']}: {' / '.join(f'{r['epe'][it]:.4f}' for it in (1504,) + HELD_OUT)}"
                  f"; mean {held:.4f}; {' / '.join(f'{m:.4f}' for m in r['loss_means'])}; {r['tf32']}"
                  f"{'' if r['rate'] is None else f'; {r['rate']:.2f} iter/s'}")
    d = r5_decision(arms["default"], jax)
    for w in d["a"]:
        print(f"[decide] rule (a), {len(arms['default'])} default seeds, losses {w['window'][0]}-{w['window'][1]}: "
              f"JAX {w['jax']:.4f}, port {w['port_min']:.4f}-{w['port_max']:.4f}: "
              f"{'within' if w['within'] else 'outside'}")
    b = d["b"]
    print(f"[decide] rule (b), mean held-out EPE over {HELD_OUT}: JAX {b['jax']:.4f}, port mean {b['port_mean']:.4f}, "
          f"sample sd {b['port_sd']:.4f}, JAX at {b['z']:+.2f} sd: {'within' if b['within'] else 'outside'} 2 sd")
    verdict = "closed as consistent" if d["closed"] else "open"
    if not d["closed"] and len(arms["exact"]) > 1:
        p = precision_decision(arms["default"], arms["exact"], jax)
        print(f"[decide] precision: losses 3104-6016, default mean {p['default_mean']:.4f}, exact-f32 mean "
              f"{p['exact_mean']:.4f} ({p['exact_min']:.4f}-{p['exact_max']:.4f}); difference {p['diff']:+.4f}, "
              f"Welch SE {p['se']:.4f}: {'more' if p['below'] else 'not more'} than 2 SE below; JAX {p['jax']:.4f} "
              f"{'within' if p['jax_within_exact'] else 'outside'} the exact arm's min-max")
        same = {r["seed"]: r for r in arms["default"]}
        pairs = [(r["seed"], r["loss_means"][1] - same[r["seed"]]["loss_means"][1]) for r in arms["exact"]
                 if r["seed"] in same]
        if pairs:  # not part of the rule: a seed does not repeat on the card
            print(f"[decide] the same seeds in both arms, exact minus default over 3104-6016: "
                  f"{', '.join(f'seed {s_}: {v:+.4f}' for s_, v in pairs)}; "
                  f"mean {statistics.mean(v for _, v in pairs):+.4f}")
        if p["named"] and not d["a"][1]["within"]:
            verdict = "precision named as the cause"
    print(f"[decide] decision: the run_r5.sh gap is {verdict}")
    return 0


def stage_seconds(log: str) -> float:
    """Seconds a stage trained, from its log's chunk rates (n iterations at r iter/s)."""
    total, last = 0.0, 0
    for it, rate in re.findall(r"^Iteration (\d+), loss = \S+ \((\S+) iter/s\)", log, re.M):
        total += (int(it) - last) / float(rate)
        last = int(it)
    return total


def cascade_run(pairs: str, work: str, out: str, iters: int, fusion_iters: int, card: str) -> dict:
    """tools.overfit_cascade on ``pairs`` at 448x320 as the JAX run took it
    (runs/cascade/log_*.txt): c, s1, s2 and sd for ``iters`` iterations
    each, then fusion for ``fusion_iters`` from that invocation's .npz; then
    tools.diag.bf16_parity on the result and the same pairs. The results
    merge as the JAX run's runs/cascade/results.json does, with each stage's
    iterations and seconds."""
    import numpy as np

    from flownet2_tpu_torch.tools.overfit import load_examples

    tool = [sys.executable, "-m", "flownet2_tpu_torch.tools.overfit_cascade", "--data", pairs, "--gpu", "0"]
    first, second = os.path.join(work, "cascade"), os.path.join(work, "cascade_fusion")  # 650 MB .npz each
    legs = [("cascade", first, ["--iters", str(iters), "--stages", "c,s1,s2,sd"]),
            ("cascade_fusion", second, ["--iters", str(fusion_iters), "--stages", "fusion",
                                        "--init-from", os.path.join(first, "flownet2_staged.npz")])]
    merged = dict(stages={}, invocations=[])
    for name, d, extra in legs:
        rc, text, secs = run(tool + extra + ["--out", d], os.path.join(out, f"{name}.log"), 3600)
        with open(os.path.join(d, "results.json")) as f:
            res = json.load(f)
        merged.setdefault("init_epe", res["init_epe"])
        for stage, r in res["stages"].items():
            shutil.copy(os.path.join(d, f"log_{stage}.txt"), os.path.join(out, f"cascade_log_{stage}.txt"))
            with open(os.path.join(d, f"log_{stage}.txt")) as f:
                r.update(iters=int(extra[1]), seconds=stage_seconds(f.read()))
            merged["stages"][stage] = r
        merged["final_epe"] = res["final_epe"]
        merged["invocations"].append(dict(argv=extra, exit=rc, seconds=secs))
        print(f"[convergence] overfit_cascade {' '.join(extra)}: {text.strip().splitlines()[-2]} "
              f"(exit {rc}, {secs:.1f} s) ({card})", flush=True)
    for stage, r in merged["stages"].items():
        print(f"[convergence] cascade stage {stage}: {r['iters']} iterations, {r['seconds'] / 60:.2f} min, loss "
              f"{r['first_loss']:.4f} -> {r['final_loss']:.4f}, cascade EPE {r['cascade_epe']:.4f} ({card})", flush=True)

    img0, img1, flow = load_examples(pairs, (320, 448))
    pairs_npz = os.path.join(work, "cascade_pairs.npz")
    np.savez(pairs_npz, img0=img0, img1=img1, flow=flow)
    rc, text, secs = run([sys.executable, "-m", "flownet2_tpu_torch.tools.diag.bf16_parity", "--weights",
                          os.path.join(second, "flownet2_staged.npz"), "--pairs", pairs_npz, "--gpu", "0"],
                         os.path.join(out, "cascade_bf16_parity.log"), 600)
    lines = text.strip().splitlines()[-3:]
    if rc != 0 or not lines[0].startswith("f32  GT-EPE"):
        raise RuntimeError(f"bf16_parity: exit {rc}\n{text[-2000:]}")
    f32, bf16 = (float(line.split(":")[1].split()[0]) for line in lines[:2])
    merged["bf16_parity"] = dict(f32_epe=f32, bf16_epe=bf16, delta=bf16 - f32, lines=lines)
    print(f"[convergence] bf16_parity on the cascade's weights and its 8 pairs at 448x320: {' | '.join(lines)} "
          f"({card})", flush=True)
    return merged


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
    p.add_argument("--r5-iters", type=int, default=6016)
    p.add_argument("--train-seeds", default="3", help="comma list: one r5 training run per seed")
    p.add_argument("--r5-pipeline", default="cache", choices=("cache", "loader"),
                   help="cache: run_r5.sh's device cache and 32 steps a dispatch; loader: BatchLoader")
    p.add_argument("--r5-min-echo", type=float, default=None,
                   help="the device cache's min_echo (default the cache's own); 16: the JAX run's turnover")
    p.add_argument("--split", default=None, help="keep the r5 split at this prefix, reusing one found there")
    p.add_argument("--r5-exact-f32", action="store_true",
                   help="train with cuDNN's TF32 off (torch.backends.cudnn.allow_tf32 = False): exact float32")
    p.add_argument("--decide", default=None, metavar="JSON[,JSON...]",
                   help="no training: pool the r5 runs of these convergence.json files by arm and apply the rules")
    p.add_argument("--overfit-iters", type=int, default=2000)
    p.add_argument("--cascade-iters", type=int, default=800)
    p.add_argument("--cascade-fusion-iters", type=int, default=None,
                   help="the fusion stage's iterations (default --cascade-iters; the JAX run's 8000)")
    args = p.parse_args(argv)
    runs = args.runs.split(",")
    if args.decide:
        return decide(args.decide.split(","))

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
        if "overfit" in runs:
            pairs = os.path.join(data, "pairs")
            write_pairs(pairs)
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
            # chip_smoke.py [tools]'s pairs: its SEED + 50, two layers, shifts up to 5 px
            casc_pairs = os.path.join(data, "cascade_pairs")
            write_pairs(casc_pairs, seed=50, n_layers=2, max_shift=5.0)
            results["cascade"] = cascade_run(casc_pairs, data, out, args.cascade_iters,
                                             args.cascade_fusion_iters or args.cascade_iters, card)
            save()
        if "r5" in runs and gen is not None:
            gen_out = gen.communicate(timeout=3600)[0]
            if gen.returncode != 0:
                raise RuntimeError(f"synth_dataset: exit {gen.returncode}\n{gen_out[-2000:]}")
            print(f"[convergence] synth_dataset 2048 + 64 samples: {time.perf_counter() - t_gen:.1f} s", flush=True)
        if "r5" in runs:
            jax = jax_r5()
            init = heldout_epe("random", prefix + "_eval.flowrec", os.path.join(out, "r5_eval_init.log"))
            runs_out = []
            pipeline = args.r5_pipeline
            if pipeline == "cache":
                pipeline += f", min_echo {args.r5_min_echo if args.r5_min_echo is not None else 'default'}"
            tag = args.r5_pipeline + ("" if args.r5_min_echo is None else f"_echo{args.r5_min_echo:g}")
            if args.r5_exact_f32:
                pipeline += ", exact float32"
                tag += "_f32"
            for seed in (int(v) for v in args.train_seeds.split(",")):
                snaps = os.path.join(data, f"snaps_{tag}_seed{seed}")
                cli = ["--model", "flownets", "--dataset", "flowrec", "--data-root", prefix + "_train.flowrec",
                       "--crop", "320x448", "--batch", "8", "--max-iter", str(args.r5_iters), "--schedule", "S_short",
                       "--solver", "adam", "--base-lr", "2e-4", "--display", "96", "--snapshot-dir", snaps,
                       "--snapshot-interval", "1504", "--seed", str(seed), "--gpu", "0"]
                if args.r5_pipeline == "cache":
                    cli += ["--device-cache", "256", "--cache-slab", "64", "--steps-per-dispatch", "32"]
                options = {} if args.r5_min_echo is None else {"min_echo": args.r5_min_echo}
                if args.r5_exact_f32:
                    options["exact_f32"] = True
                rc, text, secs = run([sys.executable, "-u", "-c", TRAIN_WITH_OPTIONS, json.dumps(options), *cli],
                                     os.path.join(out, f"r5_train_{tag}_seed{seed}.log"), 3600)
                if rc != 0:
                    raise RuntimeError(f"cli.train seed {seed}: exit {rc}")
                cache_line = next((line for line in text.splitlines() if line.startswith("Device cache:")), None)
                tf32 = [line for line in text.splitlines() if line.startswith("TF32:")][-1]
                curve = [dict(iteration=0, weights="random-init", epe=init)]
                for name in sorted(n for n in os.listdir(snaps) if n.endswith(".npz")):
                    it = int(name.split("_")[1].split(".")[0])
                    curve.append(dict(iteration=it, weights=name, epe=heldout_epe(
                        os.path.join(snaps, name), prefix + "_eval.flowrec",
                        os.path.join(out, f"r5_eval_{tag}_seed{seed}_{it:07d}.log"))))
                shutil.rmtree(snaps, ignore_errors=True)
                means, rate = loss_means(display_losses(text)), train_rate(text)
                runs_out.append(dict(seed=seed, pipeline=pipeline, train_seconds=secs, iter_per_s=rate,
                                     cache=cache_line, tf32=tf32, loss_means=means, curve=curve))
                print(f"[convergence] r5 recipe ({pipeline}), training seed {seed}, held-out mean EPE: "
                      f"{', '.join(f'{c['iteration']}: {c['epe']:.4f}' for c in curve)}; display-loss means "
                      f"{LOSS_WINDOWS}: {means}; {tf32}; {cache_line or 'no device cache'}; cli.train {secs:.1f} s, "
                      f"{rate:.2f} iter/s ({card})", flush=True)
                results["r5"] = dict(train_samples=2048, eval_samples=64, resolution="384x512", crop="320x448",
                                     iters=args.r5_iters, pipeline=pipeline, runs=runs_out, jax=jax)
                save()
            print(f"[convergence] r5 recipe ({pipeline}), {args.r5_iters} iterations; held-out EPE at "
                  f"{' / '.join(str(it) for it in (1504,) + HELD_OUT)}, display-loss means over "
                  f"{' and '.join(f'{lo}-{hi}' for lo, hi in LOSS_WINDOWS)} ({card}):", flush=True)
            for name, epe, means, extra in [(f"port seed {r['seed']}", {c["iteration"]: c["epe"] for c in r["curve"]},
                                             r["loss_means"], f"{r['tf32']}; {r['cache']}") for r in runs_out] + [
                    ("JAX TPU run (runs/synth), seed 3", jax["curve"], jax["loss_means"], jax["cache"])]:
                print(f"[convergence]   {name}: {' / '.join(f'{epe[it]:.4f}' if it in epe else '-' for it in (1504,) + HELD_OUT)}"
                      f"; {' / '.join('-' if m is None else f'{m:.4f}' for m in means)}; {extra}", flush=True)
            if len(runs_out) > 1 and args.r5_iters >= HELD_OUT[-1]:
                results["r5"]["decision"] = d = r5_decision(
                    [dict(loss_means=r["loss_means"], epe={c["iteration"]: c["epe"] for c in r["curve"]})
                     for r in runs_out], jax)
                for w in d["a"]:
                    print(f"[convergence] rule (a), losses {w['window'][0]}-{w['window'][1]}: JAX {w['jax']:.4f}, port "
                          f"{w['port_min']:.4f}-{w['port_max']:.4f}: {'within' if w['within'] else 'outside'}", flush=True)
                b_ = d["b"]
                print(f"[convergence] rule (b), mean held-out EPE over {HELD_OUT}: JAX {b_['jax']:.4f}, port "
                      f"{', '.join(f'{v:.4f}' for v in b_['port_means'])} (mean {b_['port_mean']:.4f}, sample sd "
                      f"{b_['port_sd']:.4f}, JAX at {b_['z']:+.2f} sd): {'within' if b_['within'] else 'outside'} 2 sd",
                      flush=True)
                print(f"[convergence] decision over these {len(runs_out)} seeds ({pipeline}): the run_r5.sh gap is "
                      f"{'closed' if d['closed'] else 'open'}", flush=True)
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
