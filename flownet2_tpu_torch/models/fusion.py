"""FlowNetFusion: fuses the CSS and SD flows (flownet2_tpu/models/fusion.py).

Input (11 channels): img0 (3) + sd_flow (2) + css_flow (2) + their channel
norms (1+1) + the two brightness-error magnitudes (1+1). Full resolution
with two downsamplings; predict_flow0 is the final flow. The six
full-resolution layers (conv0, conv1, deconv0, upsample_flow1to0,
inter_conv0, predict_flow0) go through ``head_block`` (the K3 kernel at
wide inputs on the card). With ``fusion_head=True``, the counterpart of the
JAX package's ``FLOWNET2_TPU_FUSION_HEAD=1``, the decoder head from
inter_conv1 on runs as one ``ops.fusion_head.fusion_head`` call (the K4
kernel on the card); default off, as there.
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch.models.common import conv, conv_block, deconv, head_block, to_nchw, to_nhwc
from flownet2_tpu_torch.ops import fusion_head as fusion_head_op


class FlowNetFusion(nn.Module):
    def __init__(self, in_channels: int = 11, *, fusion_head: bool = False):
        super().__init__()
        self.fusion_head = fusion_head
        self.conv0 = conv(in_channels, 64, 3)
        self.conv1 = conv(64, 64, 3, 2)
        self.conv1_1 = conv(64, 128, 3)
        self.conv2 = conv(128, 128, 3, 2)
        self.conv2_1 = conv(128, 128, 3)
        self.predict_flow2 = conv(128, 2, 3)
        # level 1: concat(conv1_1 128, deconv1 32, flow2up 2) = 162
        self.deconv1 = deconv(128, 32)
        self.upsample_flow2to1 = deconv(2, 2)
        self.inter_conv1 = conv(162, 32, 3)
        self.predict_flow1 = conv(32, 2, 3)
        # level 0: concat(conv0 64, deconv0 16, flow1up 2) = 82
        self.deconv0 = deconv(162, 16)
        self.upsample_flow1to0 = deconv(2, 2)
        self.inter_conv0 = conv(82, 16, 3)
        self.predict_flow0 = conv(16, 2, 3)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, 11, H, W) -> {"flow0", "flow1", "flow2"}, NCHW; flow0 is final."""
        c0 = head_block(self.conv0, x)
        c1_1 = conv_block(self.conv1_1, head_block(self.conv1, c0))
        c2_1 = conv_block(self.conv2_1, conv_block(self.conv2, c1_1))
        flow2 = conv_block(self.predict_flow2, c2_1, relu=False)

        up_feat1 = conv_block(self.deconv1, c2_1)
        up_flow1 = conv_block(self.upsample_flow2to1, flow2, relu=False)
        concat1 = torch.cat([c1_1, up_feat1, up_flow1], dim=1)
        if self.fusion_head:
            flow0, flow1 = fusion_head_op.fusion_head(concat1, c0, self)
        else:
            flow0, flow1 = self.head_unfused(concat1, c0)
        return {"flow0": flow0, "flow1": flow1, "flow2": flow2}

    def head_unfused(self, concat1: torch.Tensor, c0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder head layer by layer, the route ``fusion_head=False``
        takes: (concat1 (N,162,H/2,W/2), c0 (N,64,H,W)) -> (flow0, flow1).
        inter_conv1 and predict_flow1 (half resolution) run on their modules;
        the four full-resolution layers go through ``head_block`` (K3 on the
        card above width 512)."""
        inter1 = conv_block(self.inter_conv1, concat1, relu=False)
        flow1 = conv_block(self.predict_flow1, inter1, relu=False)
        up_feat0 = head_block(self.deconv0, concat1)
        up_flow0 = head_block(self.upsample_flow1to0, flow1, relu=False)
        concat0 = torch.cat([c0, up_feat0, up_flow0], dim=1)
        inter0 = head_block(self.inter_conv0, concat0, relu=False)
        return head_block(self.predict_flow0, inter0, relu=False), flow1


def fusion_apply(net: FlowNetFusion, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x: (N, H, W, 11) -> {"flow0", "flow1", "flow2"}, NHWC."""
    return {k: to_nhwc(v) for k, v in net(to_nchw(x)).items()}
