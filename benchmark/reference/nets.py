"""The plain reference: FlowNetC, FlowNetS, FlowNet2-SD, the fusion net and
the FlowNet2 cascade, written from the papers' deploy nets in plain PyTorch.

Sources: Dosovitskiy et al., FlowNet (ICCV 2015, arXiv:1504.06852) for
FlowNetS and FlowNetC; Ilg et al., FlowNet 2.0 (CVPR 2017,
arXiv:1612.01925) and lmb-freiburg/flownet2's FlowNet2 deploy prototxt for
the cascade, FlowNet2-SD and the fusion net, and the Caffe layers it runs
(Correlation, FlowWarp, ChannelNorm, Resample).

Weights are a dict of tensors under the ``net/layer/w`` and ``net/layer/b``
keys, conv weights (kh, kw, cin, cout) and deconv weights (kh, kw, cout,
cin): the layout the benchmark draws them in (``harness/weights.py``).
Everything runs NCHW in float32. :class:`Ops` holds the products
(convolutions, deconvolutions, the correlation); :class:`FlopCounter`
tallies their operations.

Imports nothing of the measured program.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.1
DIV_FLOW = 20.0
RGB_MAX = 255.0
CORR_MAX_DISPLACEMENT, CORR_STRIDE2 = 20, 2
CORR_CHANNELS = (2 * (CORR_MAX_DISPLACEMENT // CORR_STRIDE2) + 1) ** 2  # 441

# -- architecture: (layer, kind, cin, cout, kernel, stride); kind "conv" or "deconv" (k4, s2, p1)

_DECODER_S = (  # FlowNetS / FlowNetC refinement: level -> (deconv cin, deconv cout, skip channels)
    (5, 1024, 512, 512), (4, 1026, 256, 512), (3, 770, 128, 256), (2, 386, 64, 128))


def _refinement(levels=_DECODER_S) -> list:
    out = [("predict_flow6", "conv", 1024, 2, 3, 1)]
    for lvl, cin, dc, skip in levels:
        out += [(f"deconv{lvl}", "deconv", cin, dc, 4, 2), (f"upsample_flow{lvl + 1}to{lvl}", "deconv", 2, 2, 4, 2),
                (f"predict_flow{lvl}", "conv", skip + dc + 2, 2, 3, 1)]
    return out


_ENCODER_TAIL = [("conv4", "conv", 256, 512, 3, 2), ("conv4_1", "conv", 512, 512, 3, 1),
                 ("conv5", "conv", 512, 512, 3, 2), ("conv5_1", "conv", 512, 512, 3, 1),
                 ("conv6", "conv", 512, 1024, 3, 2), ("conv6_1", "conv", 1024, 1024, 3, 1)]


def flownet_s_layers(cin: int) -> list:
    return [("conv1", "conv", cin, 64, 7, 2), ("conv2", "conv", 64, 128, 5, 2), ("conv3", "conv", 128, 256, 5, 2),
            ("conv3_1", "conv", 256, 256, 3, 1), *_ENCODER_TAIL, *_refinement()]


def flownet_c_layers() -> list:
    return [("conv1", "conv", 3, 64, 7, 2), ("conv2", "conv", 64, 128, 5, 2), ("conv3", "conv", 128, 256, 5, 2),
            ("conv_redir", "conv", 256, 32, 1, 1), ("conv3_1", "conv", CORR_CHANNELS + 32, 256, 3, 1),
            *_ENCODER_TAIL, *_refinement()]


_SD_ENCODER = (("conv0", 6, 64, 1), ("conv1", 64, 64, 2), ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
               ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2), ("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
               ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2), ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
               ("conv6_1", 1024, 1024, 1))
_SD_SKIPS = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2_1"}


def flownet_sd_layers() -> list:
    out = [(name, "conv", cin, cout, 3, s) for name, cin, cout, s in _SD_ENCODER]
    out.append(("predict_flow6", "conv", 1024, 2, 3, 1))
    for lvl, cin, dc, skip in _DECODER_S:
        out += [(f"deconv{lvl}", "deconv", cin, dc, 4, 2), (f"upsample_flow{lvl + 1}to{lvl}", "deconv", 2, 2, 4, 2),
                (f"inter_conv{lvl}", "conv", skip + dc + 2, dc, 3, 1), (f"predict_flow{lvl}", "conv", dc, 2, 3, 1)]
    return out


def fusion_layers() -> list:
    return [("conv0", "conv", 11, 64, 3, 1), ("conv1", "conv", 64, 64, 3, 2), ("conv1_1", "conv", 64, 128, 3, 1),
            ("conv2", "conv", 128, 128, 3, 2), ("conv2_1", "conv", 128, 128, 3, 1),
            ("predict_flow2", "conv", 128, 2, 3, 1), ("deconv1", "deconv", 128, 32, 4, 2),
            ("upsample_flow2to1", "deconv", 2, 2, 4, 2), ("inter_conv1", "conv", 162, 32, 3, 1),
            ("predict_flow1", "conv", 32, 2, 3, 1), ("deconv0", "deconv", 162, 16, 4, 2),
            ("upsample_flow1to0", "deconv", 2, 2, 4, 2), ("inter_conv0", "conv", 82, 16, 3, 1),
            ("predict_flow0", "conv", 16, 2, 3, 1)]


SUBNETS = {
    "flownetc": flownet_c_layers, "flownets_1": lambda: flownet_s_layers(12),
    "flownets_2": lambda: flownet_s_layers(12), "flownetsd": flownet_sd_layers, "fusion": fusion_layers,
}


def layer_table(model: str) -> list:
    """Every layer of ``model`` as (key prefix, kind, cin, cout, kernel, stride)."""
    if model == "flownetc":
        return [(name, *rest) for name, *rest in flownet_c_layers()]
    return [(f"{net}/{name}", *rest) for net, fn in SUBNETS.items() for name, *rest in fn()]


def param_shapes(model: str) -> dict:
    """``net/layer/w`` and ``/b`` -> shape, in the weights' layout."""
    out = {}
    for key, kind, cin, cout, k, _ in layer_table(model):
        out[f"{key}/w"] = (k, k, cout, cin) if kind == "deconv" else (k, k, cin, cout)
        out[f"{key}/b"] = (cout,)
    return out


# -- the products


class Ops:
    """The reference's products: Caffe's convolution (pad k // 2), its
    k4/s2/p1 deconvolution and FlowNet's correlation."""

    def conv(self, x, w, b, stride):
        return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)

    def deconv(self, x, w, b):
        return F.conv_transpose2d(x, w, b, stride=2, padding=1)

    def corr(self, f1, f2):
        return correlation(f1, f2)


class FlopCounter(Ops):
    """:class:`Ops` that also counts the operations of each product (a
    multiply-add is two), split into conv, deconv and corr, and the
    convolutions' per-layer counts in ``layers``."""

    def __init__(self):
        self.flops = {"conv": 0, "deconv": 0, "corr": 0}
        self.layers = []

    def conv(self, x, w, b, stride):
        out = super().conv(x, w, b, stride)
        f = 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        self.flops["conv"] += f
        self.layers.append(("conv", tuple(x.shape), tuple(w.shape), stride, f))
        return out

    def deconv(self, x, w, b):
        out = super().deconv(x, w, b)
        # every output pixel of a k4/s2/p1 deconv takes 2x2 taps of each input channel
        f = 2 * out.numel() * w.shape[0] * 4
        self.flops["deconv"] += f
        self.layers.append(("deconv", tuple(x.shape), tuple(w.shape), 2, f))
        return out

    def corr(self, f1, f2):
        out = super().corr(f1, f2)
        self.flops["corr"] += 2 * out.numel() * f1.shape[1]
        return out


def prepare(params: dict, model: str, device=None) -> dict:
    """The weights as the reference uses them: ``key`` -> (OIHW or IOHW weight, bias), float32."""
    out = {}
    for key, kind, *_ in layer_table(model):
        w = torch.as_tensor(params[f"{key}/w"]).to(device=device, dtype=torch.float32)
        b = torch.as_tensor(params[f"{key}/b"]).to(device=device, dtype=torch.float32)
        # conv (kh, kw, cin, cout) -> (cout, cin, kh, kw); deconv (kh, kw, cout, cin) -> (cin, cout, kh, kw)
        out[key] = (w.permute(3, 2, 0, 1).contiguous(), b)
    return out


# -- the plain layers


def leaky(x):
    return torch.where(x >= 0, x, x * LEAKY_SLOPE)


def correlation(f1, f2, md: int = CORR_MAX_DISPLACEMENT, stride2: int = CORR_STRIDE2):
    """FlowNet's cost volume (Caffe Correlation, kernel 1, stride1 1, pad md):
    channel (p, o), y-major, is the channel mean of f1(y, x) * f2(y + p s2, x + o s2), f2 zero-padded."""
    n, c, h, w = f1.shape
    gr = md // stride2
    f2p = F.pad(f2.float(), (md, md, md, md))
    a = f1.float()
    outs = []
    for p in range(-gr, gr + 1):
        for o in range(-gr, gr + 1):
            dy, dx = md + p * stride2, md + o * stride2
            outs.append((a * f2p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1))
    return torch.stack(outs, dim=1) / c


def flow_warp(image, flow):
    """Caffe FlowWarp: bilinear sample of ``image`` at (x + u, y + v); 0
    where the position lies outside [0, W) x [0, H); the right and bottom
    neighbours clamp to the last column and row."""
    n, c, h, w = image.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image.device),
                            torch.arange(w, dtype=torch.float32, device=image.device), indexing="ij")
    x2, y2 = xs + flow[:, 0], ys + flow[:, 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    x2s = torch.where(valid, x2, 0.0).clamp(0.0, w - 1)
    y2s = torch.where(valid, y2, 0.0).clamp(0.0, h - 1)
    xb = torch.floor(x2s).long().clamp(max=w - 2)
    yb = torch.floor(y2s).long().clamp(max=h - 2)
    ax = (x2s - xb.float()).clamp(0.0, 1.0)[:, None]
    ay = (y2s - yb.float()).clamp(0.0, 1.0)[:, None]
    flat = image.float().reshape(n, c, h * w)

    def tap(r, q):
        return torch.gather(flat, 2, (r * w + q).reshape(n, 1, h * w).expand(n, c, h * w)).reshape(n, c, h, w)

    top = tap(yb, xb) * (1 - ax) + tap(yb, xb + 1) * ax
    bot = tap(yb + 1, xb) * (1 - ax) + tap(yb + 1, xb + 1) * ax
    return torch.where(valid[:, None], top * (1 - ay) + bot * ay, 0.0)


def channel_norm(x):
    return torch.sqrt((x * x).sum(dim=1, keepdim=True))


def _triangle(x):
    return np.where((x >= -1) & (x < 0), x + 1, np.where((x >= 0) & (x <= 1), 1 - x, 0.0))


@lru_cache(maxsize=64)
def _resample_matrix(n_in: int, n_out: int, f: float, f_other: float, antialias: bool) -> np.ndarray:
    """Caffe Resample (linear), one axis: output o samples the input at
    o f + f_other / 2 - 0.5 (the layer swaps the two axes' factors in its
    half-pixel offset), with a triangle kernel widened by f when
    ``antialias`` and downscaling, taps outside the input dropped and each
    output normalised by its weight sum."""
    x_in = np.arange(n_out, dtype=np.float64) * f + f_other / 2.0 - 0.5
    a = 1.0 / f if (antialias and f > 1.0) else 1.0
    r = 2 if f < 1.0 else int(math.ceil(2 / a))
    centre = np.trunc(x_in + np.copysign(0.5, x_in)).astype(np.int64)  # C round()
    idx = centre[:, None] + np.arange(-r, r + 1)[None, :]
    wts = a * _triangle(a * (x_in[:, None] - idx))
    wts = np.where((idx >= 0) & (idx < n_in), wts, 0.0)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.repeat(np.arange(n_out), idx.shape[1]), np.clip(idx, 0, n_in - 1).ravel()), wts.ravel())
    s = m.sum(axis=1, keepdims=True)
    return np.where(s != 0, m / np.where(s == 0, 1.0, s), 0.0).astype(np.float32)


def resample(x, out_h: int, out_w: int, antialias: bool = True):
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    fx, fy = w / out_w, h / out_h
    mh = torch.from_numpy(_resample_matrix(h, out_h, fy, fx, antialias)).to(x.device)
    mw = torch.from_numpy(_resample_matrix(w, out_w, fx, fy, antialias)).to(x.device)
    return torch.matmul(torch.matmul(mh, x.float()), mw.T)


def normalize_pair(img0, img1):
    """Per sample and channel, the mean over both frames subtracted; then / 255."""
    both = torch.stack([img0, img1], dim=1).float()
    both = (both - both.mean(dim=(1, 3, 4), keepdim=True)) / RGB_MAX
    return both[:, 0], both[:, 1]


# -- the nets


def _c(ops, P, key, x, stride=1, relu=True):
    w, b = P[key]
    y = ops.conv(x, w, b, stride)
    return leaky(y) if relu else y


def _d(ops, P, key, x, relu=True):
    w, b = P[key]
    y = ops.deconv(x, w, b)
    return leaky(y) if relu else y


def _refine(ops, P, pre, feats):
    flow = _c(ops, P, pre + "predict_flow6", feats[6], relu=False)
    flows, link = {6: flow}, feats[6]
    for lvl in (5, 4, 3, 2):
        up_feat = _d(ops, P, f"{pre}deconv{lvl}", link)
        up_flow = _d(ops, P, f"{pre}upsample_flow{lvl + 1}to{lvl}", flow, relu=False)
        link = torch.cat([feats[lvl], up_feat, up_flow], dim=1)
        flow = _c(ops, P, f"{pre}predict_flow{lvl}", link, relu=False)
        flows[lvl] = flow
    return flows


def flownet_c(ops, P, pre, x0, x1):
    """FlowNetC on normalized frames -> {6..2: flow / 20}."""
    def tower(x):
        c2 = _c(ops, P, pre + "conv2", _c(ops, P, pre + "conv1", x, 2), 2)
        return c2, _c(ops, P, pre + "conv3", c2, 2)

    c2a, c3a = tower(x0)
    _, c3b = tower(x1)
    corr = leaky(ops.corr(c3a, c3b))
    redir = _c(ops, P, pre + "conv_redir", c3a)
    c3_1 = _c(ops, P, pre + "conv3_1", torch.cat([corr, redir], dim=1))
    c4_1 = _c(ops, P, pre + "conv4_1", _c(ops, P, pre + "conv4", c3_1, 2))
    c5_1 = _c(ops, P, pre + "conv5_1", _c(ops, P, pre + "conv5", c4_1, 2))
    c6_1 = _c(ops, P, pre + "conv6_1", _c(ops, P, pre + "conv6", c5_1, 2))
    return _refine(ops, P, pre, {6: c6_1, 5: c5_1, 4: c4_1, 3: c3_1, 2: c2a})


def flownet_s(ops, P, pre, x):
    feats, out = {}, x
    for name, _, _, _, _, stride in flownet_s_layers(x.shape[1])[:10]:
        out = _c(ops, P, pre + name, out, stride)
        feats[name] = out
    return _refine(ops, P, pre, {6: feats["conv6_1"], 5: feats["conv5_1"], 4: feats["conv4_1"],
                                 3: feats["conv3_1"], 2: feats["conv2"]})


def flownet_sd(ops, P, pre, x):
    feats, out = {}, x
    for name, _, _, stride in _SD_ENCODER:
        out = _c(ops, P, pre + name, out, stride)
        feats[name] = out
    flow = _c(ops, P, pre + "predict_flow6", out, relu=False)
    flows, link = {6: flow}, out
    for lvl in (5, 4, 3, 2):
        up_feat = _d(ops, P, f"{pre}deconv{lvl}", link)
        up_flow = _d(ops, P, f"{pre}upsample_flow{lvl + 1}to{lvl}", flow, relu=False)
        link = torch.cat([feats[_SD_SKIPS[lvl]], up_feat, up_flow], dim=1)
        inter = _c(ops, P, f"{pre}inter_conv{lvl}", link, relu=False)
        flow = _c(ops, P, f"{pre}predict_flow{lvl}", inter, relu=False)
        flows[lvl] = flow
    return flows


def fusion(ops, P, pre, x):
    c0 = _c(ops, P, pre + "conv0", x)
    c1_1 = _c(ops, P, pre + "conv1_1", _c(ops, P, pre + "conv1", c0, 2))
    c2_1 = _c(ops, P, pre + "conv2_1", _c(ops, P, pre + "conv2", c1_1, 2))
    flow2 = _c(ops, P, pre + "predict_flow2", c2_1, relu=False)
    concat1 = torch.cat([c1_1, _d(ops, P, pre + "deconv1", c2_1),
                         _d(ops, P, pre + "upsample_flow2to1", flow2, relu=False)], dim=1)
    flow1 = _c(ops, P, pre + "predict_flow1", _c(ops, P, pre + "inter_conv1", concat1, relu=False), relu=False)
    concat0 = torch.cat([c0, _d(ops, P, pre + "deconv0", concat1),
                         _d(ops, P, pre + "upsample_flow1to0", flow1, relu=False)], dim=1)
    return _c(ops, P, pre + "predict_flow0", _c(ops, P, pre + "inter_conv0", concat0, relu=False), relu=False)


def _up4(flow, scale):
    return resample(flow * scale, flow.shape[2] * 4, flow.shape[3] * 4, antialias=False)


def flownet2(ops, P, img0, img1):
    """The FlowNet2 deploy net on raw 0-255 NCHW frames (H, W multiples of 64) -> flow in pixels."""
    x0, x1 = normalize_pair(img0, img1)
    flow = _up4(flownet_c(ops, P, "flownetc/", x0, x1)[2], DIV_FLOW)
    for stage in ("flownets_1/", "flownets_2/"):
        warped = flow_warp(x1, flow)
        stacked = torch.cat([x0, x1, warped, flow / DIV_FLOW, channel_norm(x0 - warped)], dim=1)
        flow = _up4(flownet_s(ops, P, stage, stacked)[2], DIV_FLOW)
    sd = _up4(flownet_sd(ops, P, "flownetsd/", torch.cat([x0, x1], dim=1))[2], 1.0 / DIV_FLOW)
    err_sd = channel_norm(x0 - flow_warp(x1, sd))
    err_css = channel_norm(x0 - flow_warp(x1, flow))
    stack = torch.cat([x0, sd, flow, channel_norm(sd), channel_norm(flow), err_sd, err_css], dim=1)
    return fusion(ops, P, "fusion/", stack)


def run_flownet(ops, P, img0, img1):
    """``run-flownet``'s contract on (N, H, W, 3) frames: resize to the next
    multiples of 64, FlowNet2, resize the flow back, scale u and v by
    target / adapted -> (N, H, W, 2) float32."""
    n, h, w, _ = img0.shape
    ah, aw = int(math.ceil(h / 64.0) * 64), int(math.ceil(w / 64.0) * 64)
    x0 = resample(img0.float().permute(0, 3, 1, 2), ah, aw)
    x1 = resample(img1.float().permute(0, 3, 1, 2), ah, aw)
    flow = resample(flownet2(ops, P, x0, x1), h, w, antialias=False)
    scale = torch.tensor([w / aw, h / ah], device=flow.device).view(1, 2, 1, 1)
    return (flow * scale).permute(0, 2, 3, 1)
