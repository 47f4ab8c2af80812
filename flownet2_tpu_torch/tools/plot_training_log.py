"""plot_training_log: loss/metric curves from a training log (the
tools/extra/plot_training_log.py analogue, matplotlib instead of gnuplot;
the port's copy of flownet2_tpu/tools/plot_training_log.py).

matplotlib is imported only to draw, and is optional: without it the tool
exits with a message that names it.

    python -m flownet2_tpu_torch.tools.plot_training_log LOG [--out PNG] [--log-scale]
"""

from __future__ import annotations

import argparse
import sys

from flownet2_tpu_torch.tools.parse_log import parse_log


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("logfile")
    p.add_argument("--out", default=None, help="output image (default <log>.png)")
    p.add_argument("--log-scale", action="store_true", help="log-scale the loss axis")
    args = p.parse_args(argv)

    with open(args.logfile) as f:
        train, test = parse_log(f)
    if not train and not test:
        raise SystemExit("no parsable train/test lines found")

    try:
        import matplotlib
    except ImportError:
        raise SystemExit("plot_training_log needs matplotlib, which is not installed; "
                         "tools/parse_log.py writes the same curves as CSV") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    if train:
        ax.plot([r["iteration"] for r in train], [r["loss"] for r in train],
                label="train loss", lw=1.2)
    if test:
        ax.plot([r["iteration"] for r in test], [r["metric"] for r in test],
                label="test metric", lw=1.2, marker="o", ms=3)
    if args.log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss / metric")
    ax.legend()
    ax.grid(alpha=0.3)
    out = args.out or args.logfile + ".png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
