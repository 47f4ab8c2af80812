"""The readings a check's limit is set from, on the card, in one process.

    python3 benchmark/study.py --workload CELL --seeds 1-12 [--control-seeds 1-3] [--out FILE]

For each seed, the cell's driver builds the program at the cell's own size
and compares what it produces with the plain reference
(``readings(cell, seed, device, control)``): the program's numbers on every
seed, and on ``--control-seeds`` the control's, the reference computed in
the precision below the configuration's; with ``--faults``, the program's
with each fault planted (``harness/faults.py``) on ``--fault-seeds``. One
JSON line a run, then the least and the most reading of each number by
side (program, control, fault).
A cell that ``BENCHMARK.json`` does not list yet is read from its traffic
file alone. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def seed_list(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="1-3")
    p.add_argument("--faults", default="", help="comma list of harness/faults.py faults to plant")
    p.add_argument("--fault-seeds", default="1-3")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.cell import driver, load_cell, read_spec, unlisted_cell

    if not torch.cuda.is_available():
        print("study: needs a CUDA card", file=sys.stderr)
        return 2
    listed = any(w["name"] == args.workload for w in read_spec()["workloads"])
    cell = load_cell(args.workload) if listed else unlisted_cell(args.workload)
    control = set(seed_list(args.control_seeds))
    runs = [(seed, None) for seed in seed_list(args.seeds)]
    runs += [(seed, fault) for fault in filter(None, args.faults.split(",")) for seed in seed_list(args.fault_seeds)]
    rows = []
    for seed, fault in runs:
        t0 = time.perf_counter()
        r = driver(cell).readings(cell, seed, torch.device("cuda", 0), fault is None and seed in control, fault)
        rows.append(dict(seed=seed, fault=fault, seconds=time.perf_counter() - t0, **r))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    summary = {}
    for row in rows:
        for side, items in row.items():
            if isinstance(items, list):
                label = side if row["fault"] is None else f"fault {row['fault']}"
                for item in items:
                    for k, v in item.items():
                        summary.setdefault(label, {}).setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload,
                      **{label: {k: [min(v), max(v)] for k, v in d.items()} for label, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
