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
  there) instead of a temporary directory. ``--r5-arm`` names the
  arithmetic each run trains (and scores) under, a comma list run in
  turns seed by seed, ``ARM:S+S`` for an arm on some of the seeds only:
  ``tf32`` (the CLIs' default: PyTorch's TF32 cuDNN convolutions),
  ``exact`` (cuDNN's TF32 off: exact float32, as the reference and the JAX
  package's CPU route compute; ``--r5-exact-f32`` is its alias),
  ``bf16-sample`` (the augmentation's affine sample in bfloat16 on K1,
  the JAX package's accelerator route) and ``tpu`` (the bf16 sample, and
  every conv and deconv on bfloat16-rounded operands with float32 sums,
  ``tools/diag/tpu_arith``, TF32 off, in training and in cli.test: the
  JAX TPU run's arithmetic). ``--r5-workers N`` runs up to N runs on the
  card at once (the runs are host-bound);
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
the r5 runs of earlier invocations' convergence.json files by the arm each
records and applies PERF.md's rules (``decide_runs``): rules (a) and (b)
to the TF32 arm (PR 19's ten seeds, ``PR19_TF32``, unless this call's TF32
runs drift outside their range), then to each other arm the rule that
names its arithmetic as the cause (``names_cause``) and, for a naming
arm, rules (a) and (b) on its own seeds. A training invocation ends with
the same verdicts over its own runs.

The training split is written in a separate process while the overfit and
cascade runs use the card. Each tool's own output goes to
``OUT/<run>.log``; the results go to ``OUT/convergence.json`` and, one line
each, to standard output, with the card's name and power limit.

    python3 scripts/convergence_runs.py [--out build/convergence] [--runs r5,overfit,cascade]
        [--r5-iters 6016] [--train-seeds 3[,5,...]] [--r5-pipeline cache|loader] [--r5-min-echo E]
        [--split PREFIX] [--r5-arm tf32|exact|bf16-sample|tpu[:S+S][,...]] [--r5-workers N]
        [--overfit-iters 2000] [--cascade-iters 800] [--cascade-fusion-iters F]
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
# cli.train with device-cache constructor options and an arm's arithmetic
# (JSON in argv[1]), which no flag of the CLI sets; its last line is the
# TF32 flags it trained under. "exact_f32" turns cuDNN's TF32 off before
# main, "sample_dtype" names the augmentation's affine sample dtype,
# "bf16_pass_convs" routes the net's convs through tools/diag/tpu_arith.
TRAIN_WITH_OPTIONS = ("import json, sys, torch; from flownet2_tpu_torch.cli.train import main\n"
                      "from flownet2_tpu_torch.tools.diag.tpu_arith import route_convs\n"
                      "options = json.loads(sys.argv[1])\n"
                      "if options.pop('exact_f32', False):\n"
                      "    torch.backends.cudnn.allow_tf32 = False\n"
                      "sample_dtype = getattr(torch, options.pop('sample_dtype', 'float32'))\n"
                      "hook = route_convs if options.pop('bf16_pass_convs', False) else None\n"
                      "rc = main(sys.argv[2:], cache_options=options, sample_dtype=sample_dtype, net_hook=hook)\n"
                      "print('TF32: cudnn', torch.backends.cudnn.allow_tf32, 'matmul', "
                      "torch.backends.cuda.matmul.allow_tf32); sys.exit(rc)")
# cli.test with the net's convs on bfloat16-rounded operands, TF32 off
TEST_BF16_PASS = ("import sys, torch; from flownet2_tpu_torch.cli.test import main\n"
                  "from flownet2_tpu_torch.tools.diag.tpu_arith import route_convs\n"
                  "torch.backends.cudnn.allow_tf32 = False\n"
                  "sys.exit(main(sys.argv[1:], net_hook=route_convs))")
# each arm's options for TRAIN_WITH_OPTIONS, and whether cli.test scores its
# snapshots with bfloat16-pass convolutions
ARMS = {
    "tf32": ({}, False),
    "exact": ({"exact_f32": True}, False),
    "bf16-sample": ({"sample_dtype": "bfloat16"}, False),
    "tpu": ({"exact_f32": True, "sample_dtype": "bfloat16", "bf16_pass_convs": True}, True),
}
# PR 19's ten TF32 runs of the recipe at 6016 iterations (PERF.md section 6
# of commit 9091439, its per-seed table; seeds 3-13 from PR 18's call):
# seed, held-out EPE at 1504/3008/4512/6016, display-loss means over
# 1536-3008 and 3104-6016. Their convergence.json files are not kept.
PR19_TF32 = [
    (3, 10.9106, 8.4999, 9.4003, 7.3258, 70.1932, 55.4803),
    (5, 9.2439, 9.5697, 7.7900, 9.1385, 68.8607, 54.1839),
    (7, 12.3146, 9.9384, 8.3519, 8.1696, 69.2892, 55.3237),
    (11, 9.7638, 8.6455, 7.5298, 8.8075, 69.9541, 54.8791),
    (13, 11.5810, 9.3768, 9.0893, 7.0475, 70.8910, 56.6667),
    (17, 12.0180, 10.7421, 8.4152, 9.3708, 75.4393, 58.0681),
    (19, 10.8312, 8.5260, 8.3458, 7.2900, 68.7178, 54.0572),
    (23, 11.7112, 10.4245, 8.4975, 7.8956, 72.9484, 58.5489),
    (29, 10.8920, 9.4084, 9.0931, 7.3025, 69.4658, 54.6374),
    (31, 10.6483, 8.9218, 7.9417, 7.1600, 69.7809, 55.6473),
]
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


def names_cause(base: list[dict], arm: list[dict], jax: dict) -> dict:
    """PERF.md's rule naming an arm's arithmetic as the cause of the
    later-loss gap: the arm's mean display loss over 3104-6016 lies below
    the base (TF32) arm's by more than 2 standard errors of the difference
    (Welch), and the JAX run's mean over that window lies within the arm's
    min-max."""
    d, e = ([r["loss_means"][1] for r in runs] for runs in (base, arm))
    diff = statistics.mean(d) - statistics.mean(e)
    se = (statistics.variance(d) / len(d) + statistics.variance(e) / len(e)) ** 0.5
    jax_late = jax["loss_means"][1]
    below, covers = diff > 2 * se, min(e) <= jax_late <= max(e)
    return dict(base_mean=statistics.mean(d), arm_mean=statistics.mean(e), diff=diff, se=se, below=below,
                arm_min=min(e), arm_max=max(e), jax=jax_late, jax_within_arm=covers, named=below and covers)


def train_rate(log: str) -> float:
    """Iterations a second of a cli.train log over its display chunks after
    the first (which holds the start-up and cuDNN's algorithm search)."""
    rates = re.findall(r"^Iteration (\d+), loss = \S+ \((\S+) iter/s\)", log, re.M)
    its = [int(it) for it, _ in rates]
    secs = sum((b - a) / float(r) for a, b, (_, r) in zip(its, its[1:], rates[1:]))
    return (its[-1] - its[0]) / secs


def pr19_tf32() -> list[dict]:
    """PR19_TF32 as runs of the "tf32" arm."""
    return [dict(seed=seed, arm="tf32", tf32="TF32: cudnn True matmul False (PR 19)", rate=None,
                 loss_means=[early, late], epe={1504: e1, 3008: e2, 4512: e3, 6016: e4})
            for seed, e1, e2, e3, e4, early, late in PR19_TF32]


def r5_rows(runs: list[dict]) -> list[dict]:
    """The runs of convergence.json's "r5" entry as decide_runs takes them."""
    return [dict(seed=r["seed"], arm=r["arm"], tf32=r["tf32"], loss_means=r["loss_means"], rate=r.get("iter_per_s"),
                 epe={c["iteration"]: c["epe"] for c in r["curve"]}) for r in runs]


def decide_runs(runs: list[dict], jax: dict, log=print) -> str:
    """PERF.md's rules over runs pooled by arm (``r5_rows``); returns the
    decision. The TF32 arm is PR 19's ten runs unless a TF32 run here has
    its 3104-6016 loss mean outside their range (drift): then the TF32 runs
    here are the arm. Rules (a) and (b) over the TF32 arm; for each other
    arm, ``names_cause`` and, where it names, rules (a) and (b) over the
    arm's own seeds. The bf16 sample is read before the whole TPU
    arithmetic (it stacks on the sample): the first naming arm of the two
    decides."""
    arms: dict[str, list] = {}
    for r in runs:
        arms.setdefault(r["arm"], []).append(r)
    base = pr19_tf32()
    lo, hi = min(r["loss_means"][1] for r in base), max(r["loss_means"][1] for r in base)
    drift = [r for r in arms.get("tf32", []) if not lo <= r["loss_means"][1] <= hi]
    for r in arms.get("tf32", []):
        log(f"[decide] TF32 drift check, seed {r['seed']}: losses 3104-6016 {r['loss_means'][1]:.4f}, "
            f"PR 19's ten seeds {lo:.4f}-{hi:.4f}: {'outside' if r in drift else 'within'}")
    if drift:
        if len(arms["tf32"]) < 5:
            log("[decide] decision: undecided: the TF32 arm drifted; train TF32 on all ten seeds")
            return "undecided"
        base = arms["tf32"]
        log(f"[decide] the TF32 arm drifted: its {len(base)} runs here replace PR 19's")
    else:
        log("[decide] the TF32 arm: PR 19's ten seeds (PR19_TF32)")
    arms["tf32"] = base
    for arm, rows in arms.items():
        for r in rows:
            held = sum(r["epe"][it] for it in HELD_OUT) / len(HELD_OUT)
            log(f"[decide] {arm} seed {r['seed']}: {' / '.join(f'{r['epe'][it]:.4f}' for it in (1504,) + HELD_OUT)}"
                f"; mean {held:.4f}; {' / '.join(f'{m:.4f}' for m in r['loss_means'])}; {r['tf32']}"
                f"{'' if r['rate'] is None else f'; {r['rate']:.2f} iter/s'}")

    def rules(name, rows):
        d = r5_decision(rows, jax)
        for w in d["a"]:
            log(f"[decide] rule (a), {len(rows)} {name} seeds, losses {w['window'][0]}-{w['window'][1]}: "
                f"JAX {w['jax']:.4f}, port {w['port_min']:.4f}-{w['port_max']:.4f}: "
                f"{'within' if w['within'] else 'outside'}")
        b = d["b"]
        log(f"[decide] rule (b), {name}, mean held-out EPE over {HELD_OUT}: JAX {b['jax']:.4f}, port mean "
            f"{b['port_mean']:.4f}, sample sd {b['port_sd']:.4f}, JAX at {b['z']:+.2f} sd: "
            f"{'within' if b['within'] else 'outside'} 2 sd")
        return d["closed"]

    if rules("tf32", base):
        log("[decide] decision: the run_r5.sh gap is closed as consistent")
        return "closed as consistent"
    named = {}
    for arm in ("exact", "bf16-sample", "tpu"):
        rows = arms.get(arm, [])
        if len(rows) < 2:
            continue
        p = names_cause(base, rows, jax)
        log(f"[decide] arm {arm}, {len(rows)} seeds: losses 3104-6016 mean {p['arm_mean']:.4f} "
            f"({p['arm_min']:.4f}-{p['arm_max']:.4f}) against TF32's {p['base_mean']:.4f}; difference "
            f"{p['diff']:+.4f}, Welch SE {p['se']:.4f}: {'more' if p['below'] else 'not more'} than 2 SE below; "
            f"JAX {p['jax']:.4f} {'within' if p['jax_within_arm'] else 'outside'} its min-max: "
            f"{'names' if p['named'] else 'does not name'} its arithmetic")
        same = {r["seed"]: r for r in base}
        pairs = [(r["seed"], r["loss_means"][1] - same[r["seed"]]["loss_means"][1]) for r in rows if r["seed"] in same]
        if pairs:  # not part of the rule: a seed does not repeat on the card
            log(f"[decide] arm {arm} minus TF32 on the same seeds, 3104-6016 (outside the rule): "
                f"{', '.join(f'seed {s_}: {v:+.4f}' for s_, v in pairs)}; "
                f"mean {statistics.mean(v for _, v in pairs):+.4f}")
        if p["named"]:
            named[arm] = rules(arm, rows)
    cause = next((arm for arm in ("bf16-sample", "tpu") if arm in named), None)
    if cause is not None:
        what = {"bf16-sample": "the bf16 sample", "tpu": "the TPU run's whole arithmetic"}[cause]
        verdict = (f"{what} accounts for the gap: " + ("closed as the TPU run's arithmetic, not a port fault"
                                                       if named[cause] else
                                                       "still open: rule (a) or (b) fails on its own seeds"))
    elif "bf16-sample" in arms or "tpu" in arms:
        verdict = "neither arm names the cause: open, with precision and the sample excluded"
    elif named:
        verdict = "precision names the cause: " + ("closed" if named["exact"] else "still open")
    else:
        verdict = "open"
    log(f"[decide] decision: {verdict}")
    return verdict


def decide(paths: list[str]) -> int:
    """Pool the r5 runs of several convergence.json files by the arm each
    records and apply ``decide_runs``."""
    runs, jax = [], None
    for path in paths:
        with open(path) as f:
            r5 = json.load(f)["r5"]
        jax = r5["jax"]
        runs += r5_rows(r5["runs"])
    decide_runs(runs, dict(jax, curve={int(k): v for k, v in jax["curve"].items()}))
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


def heldout_epe(weights: str, eval_rec: str, log_path: str, bf16_pass: bool = False) -> float:
    """cli.test's mean EPE of FlowNetS ``weights`` on the held-out split;
    ``bf16_pass``: its convs on bfloat16-rounded operands (TEST_BF16_PASS)."""
    test = ["-c", TEST_BF16_PASS] if bf16_pass else ["-m", "flownet2_tpu_torch.cli.test"]
    rc, out, _ = run([sys.executable, *test, "--weights", weights, "--model", "flownets",
                      "--dataset", "flowrec", "--data-root", eval_rec, "--batch", "4", "--gpu", "0"], log_path, 600)
    if rc != 0:
        raise RuntimeError(f"cli.test {weights}: exit {rc}")
    return float([line for line in out.splitlines() if line.startswith("Loss:")][-1].rsplit("=", 1)[1])


def r5_jobs(spec: str, seeds: list[int]) -> list[tuple[int, str]]:
    """(seed, arm) of each r5 run, seed by seed with the arms in turns:
    ``spec`` is a comma list of arms, ``ARM:S+S`` for an arm on those of
    ``seeds`` only."""
    arms = {}
    for item in spec.split(","):
        arm, _, only = item.partition(":")
        if arm not in ARMS:
            raise SystemExit(f"--r5-arm: unknown arm {arm!r} (one of {', '.join(ARMS)})")
        arms[arm] = {int(v) for v in only.split("+")} if only else set(seeds)
    return [(seed, arm) for seed in seeds for arm, on in arms.items() if seed in on]


def r5_runs(args, jobs: list[tuple[int, str]], prefix: str, data: str, out: str, card: str, results: dict,
            save) -> None:
    """Train and score the r5 recipe once for each (seed, arm) of ``jobs``,
    up to ``--r5-workers`` at once, in the jobs' order; then the verdicts
    of ``decide_runs`` over them at the recipe's full length. The runs go
    to ``results["r5"]``, saved as each ends."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    jax = jax_r5()
    eval_rec = prefix + "_eval.flowrec"
    pipeline = args.r5_pipeline
    if pipeline == "cache":
        pipeline += f", min_echo {args.r5_min_echo if args.r5_min_echo is not None else 'default'}"
    tag = args.r5_pipeline + ("" if args.r5_min_echo is None else f"_echo{args.r5_min_echo:g}")
    init = {bf16: heldout_epe("random", eval_rec, os.path.join(out, f"r5_eval_init{'_bf16pass' if bf16 else ''}.log"),
                              bf16) for bf16 in sorted({ARMS[arm][1] for _, arm in jobs})}
    done: dict[tuple, dict] = {}
    lock = threading.Lock()
    r5 = dict(train_samples=2048, eval_samples=64, resolution="384x512", crop="320x448", iters=args.r5_iters,
              pipeline=pipeline, workers=args.r5_workers, runs=[], jax=jax)
    results["r5"] = r5

    def one(seed: int, arm: str) -> None:
        options, bf16_pass = ARMS[arm]
        name = f"{tag}_{arm}_seed{seed}"
        snaps = os.path.join(data, f"snaps_{name}")
        cli = ["--model", "flownets", "--dataset", "flowrec", "--data-root", prefix + "_train.flowrec",
               "--crop", "320x448", "--batch", "8", "--max-iter", str(args.r5_iters), "--schedule", "S_short",
               "--solver", "adam", "--base-lr", "2e-4", "--display", "96", "--snapshot-dir", snaps,
               "--snapshot-interval", "1504", "--seed", str(seed), "--gpu", "0"]
        if args.r5_pipeline == "cache":
            cli += ["--device-cache", "256", "--cache-slab", "64", "--steps-per-dispatch", "32"]
        options = dict(options, **({} if args.r5_min_echo is None else {"min_echo": args.r5_min_echo}))
        rc, text, secs = run([sys.executable, "-u", "-c", TRAIN_WITH_OPTIONS, json.dumps(options), *cli],
                             os.path.join(out, f"r5_train_{name}.log"), 3600)
        if rc != 0:
            raise RuntimeError(f"cli.train {arm} seed {seed}: exit {rc}")
        cache_line = next((line for line in text.splitlines() if line.startswith("Device cache:")), None)
        tf32 = [line for line in text.splitlines() if line.startswith("TF32:")][-1]
        curve = [dict(iteration=0, weights="random-init", epe=init[bf16_pass])]
        for snap in sorted(n for n in os.listdir(snaps) if n.endswith(".npz")):
            it = int(snap.split("_")[1].split(".")[0])
            curve.append(dict(iteration=it, weights=snap, epe=heldout_epe(
                os.path.join(snaps, snap), eval_rec, os.path.join(out, f"r5_eval_{name}_{it:07d}.log"), bf16_pass)))
        shutil.rmtree(snaps, ignore_errors=True)
        means, rate = loss_means(display_losses(text)), train_rate(text)
        row = dict(seed=seed, arm=arm, pipeline=pipeline, train_seconds=secs, iter_per_s=rate, cache=cache_line,
                   tf32=tf32, loss_means=means, curve=curve)
        print(f"[convergence] r5 recipe ({pipeline}), arm {arm}, training seed {seed}, held-out mean EPE: "
              f"{', '.join(f'{c['iteration']}: {c['epe']:.4f}' for c in curve)}; display-loss means "
              f"{LOSS_WINDOWS}: {means}; {tf32}; {cache_line or 'no device cache'}; cli.train {secs:.1f} s, "
              f"{rate:.2f} iter/s ({card})", flush=True)
        with lock:
            done[seed, arm] = row
            r5["runs"] = [done[j] for j in jobs if j in done]
            save()

    with ThreadPoolExecutor(max_workers=max(1, args.r5_workers)) as pool:
        for f in [pool.submit(one, seed, arm) for seed, arm in jobs]:
            f.result()
    print(f"[convergence] r5 recipe ({pipeline}), {args.r5_iters} iterations, {args.r5_workers} at once; held-out "
          f"EPE at {' / '.join(str(it) for it in (1504,) + HELD_OUT)}, display-loss means over "
          f"{' and '.join(f'{lo}-{hi}' for lo, hi in LOSS_WINDOWS)} ({card}):", flush=True)
    for name, epe, means, extra in [(f"port {r['arm']} seed {r['seed']}", {c["iteration"]: c["epe"] for c in r["curve"]},
                                     r["loss_means"], f"{r['tf32']}; {r['cache']}") for r in r5["runs"]] + [
            ("JAX TPU run (runs/synth), seed 3", jax["curve"], jax["loss_means"], jax["cache"])]:
        print(f"[convergence]   {name}: {' / '.join(f'{epe[it]:.4f}' if it in epe else '-' for it in (1504,) + HELD_OUT)}"
              f"; {' / '.join('-' if m is None else f'{m:.4f}' for m in means)}; {extra}", flush=True)
    if args.r5_iters >= HELD_OUT[-1]:
        r5["decision"] = decide_runs(r5_rows(r5["runs"]), jax,
                                     log=lambda m: print(m.replace("[decide]", "[convergence]"), flush=True))


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
    p.add_argument("--r5-arm", default=None, metavar="ARM[:S+S][,...]",
                   help=f"the arithmetic of the r5 runs, {', '.join(ARMS)} (default tf32); several run in turns "
                        "seed by seed; ARM:S+S runs an arm on those of --train-seeds only")
    p.add_argument("--r5-exact-f32", action="store_true", help="the same as --r5-arm exact")
    p.add_argument("--r5-workers", type=int, default=1, help="r5 runs on the card at once")
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
    if args.r5_exact_f32 and args.r5_arm:
        p.error("--r5-exact-f32 is --r5-arm exact: give one of them")
    seeds = [int(v) for v in args.train_seeds.split(",")]
    jobs = r5_jobs("exact" if args.r5_exact_f32 else args.r5_arm or "tf32", seeds)
    if not jobs:
        p.error("--r5-arm names no run on --train-seeds")

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
            r5_runs(args, jobs, prefix, data, out, card, results, save)
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
