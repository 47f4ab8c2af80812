"""Net summarization tool (the reference's tools/extra/summarize.py:1-10,
which tabulates a prototxt's layers "to check at a glance that the
computation you've specified is the computation you expect"; the port of
flownet2_tpu/tools/summarize.py).

The table lists every parameterized layer of the model's net with its
weight and bias shapes (the JAX package's layout: HWIO convs, (kh, kw,
Cout, Cin) deconvs) and parameter count, per-subnet subtotals for the
cascade models, then the output shapes of one no-grad forward at the
requested size on the card (or with ``--device cpu`` on the CPU): the
forward's flow (N, H, W, 2), as the JAX tool prints it, and each scale the
last sub-net predicts (NHWC). Without a card and without ``--device`` the
tool exits with an error.

Usage: python -m flownet2_tpu_torch.tools.summarize flownet2 [--height 320]
       [--width 448] [--batch 1] [--gpu N | --device cpu]
"""

from __future__ import annotations

import argparse
import sys


def _layer_rows(params: dict) -> list[tuple[str, tuple, tuple | None, int]]:
    """Flat ``layer/w`` and ``layer/b`` parameters (``sub/layer/...`` for
    cascade subnets) -> (name, w_shape, b_shape, count) rows in order."""
    rows = {}
    for key, v in params.items():
        name, leaf = key.rsplit("/", 1)
        w, b, count = rows.get(name, (None, None, 0))
        if leaf == "w":
            w = tuple(v.shape)
        else:
            b = tuple(v.shape)
        rows[name] = (w, b, count + int(v.size))
    return [(name, w, b, count) for name, (w, b, count) in rows.items()]


def summarize(model: str, height: int, width: int, batch: int, *, device, out=sys.stdout) -> int:
    import torch

    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.inference import _make_forward
    from flownet2_tpu_torch.models import NETS, DispNetC, FlowNetC, FlowNetFusion, FlowNetS, FlowNetSD

    params = init_params(model, seed=0)
    rows = _layer_rows(params)

    name_w = max(len(r[0]) for r in rows) + 1
    print(f"{'layer':<{name_w}} {'weights':<20} {'bias':<10} {'params':>10}", file=out)
    total = 0
    subtotals: dict[str, int] = {}
    for name, ws, bs, count in rows:
        total += count
        if "/" in name:
            subtotals[name.split("/")[0]] = subtotals.get(name.split("/")[0], 0) + count
        print(
            f"{name:<{name_w}} {str(ws):<20} {str(bs) if bs else '-':<10} {count:>10,}",
            file=out,
        )
    for sub, cnt in subtotals.items():
        print(f"{'[' + sub + ']':<{name_w}} {'':<20} {'':<10} {cnt:>10,}", file=out)
    print(f"{'TOTAL':<{name_w}} {'':<20} {'':<10} {total:>10,}", file=out)

    with torch.device("meta"):
        net = NETS[model]()
    net = load_into(net, params).to(device).eval()
    # the scales of the last sub-net the forward runs (for FlowNet2 the fusion net)
    scales = {}

    def keep(module, args, flows):
        scales.clear()
        scales.update(flows)

    subnets = (FlowNetC, FlowNetS, FlowNetSD, FlowNetFusion, DispNetC)
    hooks = [m.register_forward_hook(keep) for m in net.modules() if type(m) in subnets]
    img = torch.zeros(batch, 3, height, width, device=device)
    try:
        with torch.no_grad():
            flow = _make_forward(model)(net, img, img)
    finally:
        for h in hooks:
            h.remove()
    print(f"\noutput @ {width}x{height} (batch {batch}):", file=out)
    print(f"  {tuple(flow.permute(0, 2, 3, 1).shape)}", file=out)
    for name, f in scales.items():
        print(f"  {name}: {tuple(f.permute(0, 2, 3, 1).shape)}", file=out)
    return total


def main(argv=None) -> int:
    from flownet2_tpu_torch.cli.run_flownet import device_from_args
    from flownet2_tpu_torch.models import NETS

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=sorted(NETS))
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index to use")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    args = p.parse_args(argv)
    summarize(args.model, args.height, args.width, args.batch, device=device_from_args(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
