"""The benchmark of flownet2_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Reads ``BENCHMARK.json``, finds the cell's files (``harness/cell.py``),
makes its inputs and weights on the card from ``--seed``, warms up the
cell's shapes, then drives its traffic for ``--seconds``. With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` a
stretch of the window runs under ``torch.profiler`` and the result carries
the per-layer metrics and the breakdown. After the window the program's
outputs are compared with the plain reference (``correct``). The last line
of standard output is the result as one JSON object; the numbers compared
and their limits close standard error and the result.

Exits non-zero, printing no result, without the card(s) the cell needs, or
when a module of jax, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the program's kernel library is built into <checkout>/build/ by its own
# build module; a kernel cache PyTorch keeps for itself goes there too
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", os.path.join(ROOT, "build", "benchmark", "torch_kernels"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.cell import driver, load_cell
    from benchmark.harness.common import forbidden_loaded

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seed = args.seed % (1 << 63)
    result = driver(cell).run(cell, seed, args.seconds, bool(args.trace), device)
    line = result_line(cell, result, args.trace, device)
    bad = forbidden_loaded(sys.modules)
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result.checks.items():
        print(f"check {name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def result_line(cell, result, trace: int, device) -> dict:
    import torch

    from benchmark.harness.cell import metric_reader

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(result.memory_peak_bytes), "power_limit": power_limit()}
    if trace:
        from benchmark.harness.trace import breakdown

        st = result.stretch
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(st)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=st.busy_us() / 1e6, window_s=st.wall_s)
        extra = {"breakdown": breakdown(st)}
    else:
        values = dict(result.end_to_end, setup_s=result.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        extra = {}
    return {"correct": is_correct(result), "attempted": result.attempted, "failed": result.failed, "metrics": metrics,
            "device": dev, **extra,
            "checks": {k: {"value": c.value, "limit": c.limit} for k, c in result.checks.items()}}


def is_correct(result) -> bool:
    """No failed request or step, and every compared number within its limit."""
    return result.failed == 0 and all(c.ok for c in result.checks.values())


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it; None where it cannot."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
