"""Training-log parsing → CSV (the tools/extra/parse_log.py analogue; the
port's copy of flownet2_tpu/tools/parse_log.py, standard library only).

Parses the Solver's display lines
(``Iteration N, loss = X (R iter/s)`` and ``Iteration N, test metric = Y``)
into (train, test) tables, for plotting or regression tracking.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from typing import TextIO

_TRAIN_RE = re.compile(
    r"Iteration (\d+), loss = ([0-9.eE+-]+|nan|inf)(?: \(([0-9.eE+-]+) iter/s\))?"
)
_TEST_RE = re.compile(r"Iteration (\d+), test metric = ([0-9.eE+-]+|nan|inf)")


def parse_log(lines) -> tuple[list[dict], list[dict]]:
    train, test = [], []
    for line in lines:
        m = _TRAIN_RE.search(line)
        if m:
            train.append(
                {
                    "iteration": int(m.group(1)),
                    "loss": float(m.group(2)),
                    "iters_per_sec": float(m.group(3)) if m.group(3) else None,
                }
            )
            continue
        m = _TEST_RE.search(line)
        if m:
            test.append({"iteration": int(m.group(1)), "metric": float(m.group(2))})
    return train, test


def _write_csv(rows: list[dict], out: TextIO) -> None:
    if not rows:
        return
    w = csv.DictWriter(out, fieldnames=list(rows[0]))
    w.writeheader()
    w.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("logfile")
    p.add_argument("--train-out", default=None, help="CSV path (default: <log>.train.csv)")
    p.add_argument("--test-out", default=None, help="CSV path (default: <log>.test.csv)")
    args = p.parse_args(argv)

    with open(args.logfile) as f:
        train, test = parse_log(f)
    with open(args.train_out or args.logfile + ".train.csv", "w") as f:
        _write_csv(train, f)
    with open(args.test_out or args.logfile + ".test.csv", "w") as f:
        _write_csv(test, f)
    print(f"parsed {len(train)} train rows, {len(test)} test rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
