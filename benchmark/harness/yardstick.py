"""The yardstick: the card's peaks and the least time each kernel could take.

A bound is the larger of two times (``bound``): the bytes the function
needs, each input read once and each output written once, over the
memory's rate; and its operations over the peak of the configuration's
arithmetic for products. Both configurations compute in float32 with
PyTorch's default flags, under which cuDNN runs convolutions in TF32, so
the product peak is TF32's, whichever unit a kernel runs on: a share then
reads the same work whatever implements it, and no faithful rewrite can
pass 100%. The counts are those of the port's ``chip_smoke.py`` (``bound``,
``corr_bound``, ``corr_bwd_bound``, ``warp_bounds``, K3's per-layer counts),
frozen here with that peak. Published peaks of one H100 SXM, dense: NVIDIA's
data sheet.
"""

from __future__ import annotations

import torch

from benchmark.reference import nets

PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_TF32_FLOPS) -> float:
    """Seconds: the larger of the bytes over the memory rate and the operations over the peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def corr_bound(n: int, c: int, h: int, w: int) -> float:
    """K5 forward at features (n, c, h, w): f1 and f2 read, 441 channels written,
    one multiply-add per channel and displacement."""
    k = nets.CORR_CHANNELS
    return bound(F32 * (2 * n * c * h * w + n * k * h * w), 2 * n * k * h * w * c)


def corr_bwd_bound(n: int, c: int, h: int, w: int) -> float:
    """K5 backward: f1, f2 and the 441-channel gradient read, df1 and df2
    written, two multiply-adds per channel and displacement."""
    k = nets.CORR_CHANNELS
    return bound(F32 * (4 * n * c * h * w + n * k * h * w), 4 * n * k * h * w * c)


def warp_bound(n: int, c: int, h: int, w: int) -> float:
    """K1 over (n, c, h, w) float32: image and flow read, output written, 3 lerps (9 operations) a channel."""
    px = n * h * w
    return bound(F32 * px * (c + 2 + c), 9 * c * px)


def head_conv_bound(x_shape, w_shape, kind: str, stride: int) -> float:
    """K3 on one head layer: input, weight, bias read and output written once;
    k*k taps (a k4/s2 deconv: 2x2) of each input channel per output value."""
    n, cin, h, w = x_shape
    if kind == "deconv":
        cout, taps, ho, wo = w_shape[1], 4, 2 * h, 2 * w
    else:
        k = w_shape[-1]
        cout, taps, ho, wo = w_shape[0], k * k, (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    out = n * cout * ho * wo
    wnum = cin * cout * taps * (4 if kind == "deconv" else 1)  # a deconv weight holds 4x4 taps
    return bound(F32 * (n * cin * h * w + wnum + cout + out), 2 * out * cin * taps)


def _counted(model: str, n: int, h: int, w: int) -> nets.FlopCounter:
    """The reference run on the meta device (shapes only) with its products counted."""
    P = nets.prepare({k: torch.empty(s, device="meta") for k, s in nets.param_shapes(model).items()}, model, "meta")
    counter = nets.FlopCounter()
    x = torch.empty(n, 3, h, w, device="meta")
    with torch.no_grad():
        if model == "flownet2":
            nets.flownet2(counter, P, x, x)
        else:
            nets.flownet_c(counter, P, "", *nets.normalize_pair(x, x))
    return counter


def forward_flops(model: str, h: int, w: int) -> dict:
    """A pair's forward operations at the net's (adapted) size: conv, deconv and corr."""
    return dict(_counted(model, 1, h, w).flops)


def train_flops(model: str, h: int, w: int) -> float:
    """A training pair's operations: the forward, and twice it for the
    backward (each product's two gradients), less the input gradient of the
    first layers, which the images do not need."""
    counter = _counted(model, 1, h, w)
    first = sum(f for kind, x, _, _, f in counter.layers if kind == "conv" and x[1] == 3)
    return 3 * sum(counter.flops.values()) - first


def head_layers(model: str, n: int, h: int, w: int, min_width: int = 512) -> list:
    """The full-resolution head layers the port routes to K3 at (h, w), as
    (kind, x shape, weight shape, stride): the convs and deconvs whose
    full-resolution width (a conv's input, a deconv's output) is ``w`` and above ``min_width``."""
    if w <= min_width:
        return []
    out = []
    for kind, x, wt, stride, _ in _counted(model, n, h, w).layers:
        width = 2 * x[3] if kind == "deconv" else x[3]
        if width == w:
            out.append((kind, x, wt, stride))
    return out
