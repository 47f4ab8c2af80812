"""The stacked FlowNet2 cascade: C -> S1 -> S2 (+ SD) -> fusion.

Counterpart of flownet2_tpu/models/flownet2.py, deploy-graph semantics:

1. normalize: subtract the per-sample, per-channel mean over both frames and
   scale by 1/255;
2. FlowNetC on (img0, img1) predicts flow/20 at 1/4 resolution -> x20,
   linear x4 upsample to full resolution;
3. warp img1 backward by the flow, brightness error ChannelNorm(img0 -
   warped), stack [img0, img1, warped, flow/20, err] (12 channels) ->
   FlowNetS1 -> the same upsampling;
4. the same again with FlowNetS2 -> css flow;
5. FlowNet2-SD on [img0, img1] -> sd flow (its upsampled output is divided
   by 20: the SD net predicts at full scale);
6. the fusion net on [img0, sd, css, |sd|, |css|, |err_sd|, |err_css|].

The ``*_forward`` functions work on NCHW tensors; the ``*_apply`` functions
take and return NHWC, as the JAX package's do. Each sub-net runs inside a
``torch.profiler.record_function`` range named after its attribute of
:class:`FlowNet2` (``fn2.net.flownetc`` ... ``fn2.net.fusion``); the glue
between them runs outside.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from flownet2_tpu_torch.models.common import to_nchw, to_nhwc
from flownet2_tpu_torch.models.flownet_c import FlowNetC
from flownet2_tpu_torch.models.flownet_s import FlowNetS
from flownet2_tpu_torch.models.flownet_sd import FlowNetSD
from flownet2_tpu_torch.models.fusion import FlowNetFusion
from flownet2_tpu_torch.ops.channel_norm import channel_norm
from flownet2_tpu_torch.ops.resample import resample
from flownet2_tpu_torch.ops.warp import flow_warp

DIV_FLOW = 20.0
RGB_MAX = 255.0


class FlowNet2(nn.Module):
    """The five sub-nets. The ``flownet2*_forward`` functions below run them
    as FlowNet2, FlowNet2-CS or FlowNet2-CSS, which share the weights.
    ``fusion_head``: the fusion net's fused decoder head (``FlowNetFusion``)."""

    def __init__(self, *, fusion_head: bool = False):
        super().__init__()
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS(in_channels=12)
        self.flownets_2 = FlowNetS(in_channels=12)
        self.flownetsd = FlowNetSD()
        self.fusion = FlowNetFusion(fusion_head=fusion_head)


def normalize_images(img0: torch.Tensor, img1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 3, H, W) pair: per-sample per-channel mean over both frames
    subtracted, then /255. Statistics in float32, outputs in the input dtype."""
    dtype = img0.dtype
    both = torch.stack([img0, img1], dim=1).float()  # (N, 2, 3, H, W)
    mean = both.mean(dim=(1, 3, 4), keepdim=True)
    both = ((both - mean) / RGB_MAX).to(dtype)
    return both[:, 0].contiguous(), both[:, 1].contiguous()


def _upsample_flow_4x(flow_quarter: torch.Tensor, scale: float) -> torch.Tensor:
    """x4 linear upsample of a 1/4-resolution flow, values scaled by ``scale``."""
    h, w = flow_quarter.shape[2] * 4, flow_quarter.shape[3] * 4
    return resample(flow_quarter * scale, h, w, antialias=False)


def _cascade_stage(net: FlowNet2, stage: str, x0, x1, flow_full):
    """One S refinement stage (``stage``: ``flownets_1`` or ``flownets_2``):
    warp, error, stack, run that FlowNetS."""
    warped = flow_warp(x1, flow_full)
    err = channel_norm(x0 - warped)
    stacked = torch.cat([x0, x1, warped, flow_full / DIV_FLOW, err], dim=1)
    with record_function(f"fn2.net.{stage}"):
        flows = getattr(net, stage)(stacked)
    return _upsample_flow_4x(flows["flow2"], DIV_FLOW), flows


def _cs(net: FlowNet2, x0, x1) -> torch.Tensor:
    with record_function("fn2.net.flownetc"):
        flows_c = net.flownetc(x0, x1)
    flow_c = _upsample_flow_4x(flows_c["flow2"], DIV_FLOW)
    return _cascade_stage(net, "flownets_1", x0, x1, flow_c)[0]


def _css(net: FlowNet2, x0, x1) -> torch.Tensor:
    return _cascade_stage(net, "flownets_2", x0, x1, _cs(net, x0, x1))[0]


def build_fusion_inputs(net: FlowNet2, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Everything upstream of the fusion net, on normalized NCHW frames: the
    CSS branch, the SD branch and the 11-channel fusion input stack."""
    css_flow = _css(net, x0, x1)
    both = torch.cat([x0, x1], dim=1)
    with record_function("fn2.net.flownetsd"):
        flows_sd = net.flownetsd(both)
    sd_flow = _upsample_flow_4x(flows_sd["flow2"], 1.0 / DIV_FLOW)
    err_sd = channel_norm(x0 - flow_warp(x1, sd_flow))
    err_css = channel_norm(x0 - flow_warp(x1, css_flow))
    return torch.cat(
        [x0, sd_flow, css_flow, channel_norm(sd_flow), channel_norm(css_flow), err_sd, err_css], dim=1
    )


def flownet2_cs_forward(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """FlowNet2-CS (C -> S1) on raw (N, 3, H, W) frames -> (N, 2, H, W) flow."""
    return _cs(net, *normalize_images(img0, img1))


def flownet2_css_forward(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """FlowNet2-CSS (C -> S1 -> S2) on raw (N, 3, H, W) frames."""
    return _css(net, *normalize_images(img0, img1))


def flownet2_forward(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Full FlowNet2 on raw 0-255 (N, 3, H, W) frames, H and W divisible by
    64 -> (N, 2, H, W) flow."""
    x0, x1 = normalize_images(img0, img1)
    fused_in = build_fusion_inputs(net, x0, x1)
    with record_function("fn2.net.fusion"):
        return net.fusion(fused_in)["flow0"]


def flownet2_cs_apply(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """NHWC: img* (N, H, W, 3) raw RGB -> (N, H, W, 2) flow."""
    return to_nhwc(flownet2_cs_forward(net, to_nchw(img0), to_nchw(img1)))


def flownet2_css_apply(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """NHWC: img* (N, H, W, 3) raw RGB -> (N, H, W, 2) flow."""
    return to_nhwc(flownet2_css_forward(net, to_nchw(img0), to_nchw(img1)))


def flownet2_apply(net: FlowNet2, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """NHWC: img* (N, H, W, 3) raw RGB -> (N, H, W, 2) flow."""
    return to_nhwc(flownet2_forward(net, to_nchw(img0), to_nchw(img1)))
