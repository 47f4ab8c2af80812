"""FlowNetC: siamese feature towers + correlation (flownet2_tpu/models/flownet_c.py).

conv1-3 run on each image with shared weights, then the correlation
(max_displacement 20, stride2 2, pad 20 -> 441 channels) at the conv3
resolution (stride 8), leaky ReLU, a 1x1 conv_redir branch (32 channels) on
the img0 tower, and the FlowNetS decoder on the 473 concatenated channels.
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch.models.common import (
    add_refinement_decoder,
    conv,
    conv_block,
    head_block,
    refinement_decoder,
    to_nchw,
    to_nhwc,
)
from flownet2_tpu_torch.ops.activations import leaky_relu
from flownet2_tpu_torch.ops.correlation import correlation

CORR_KWARGS = dict(max_displacement=20, kernel_size=1, stride1=1, stride2=2, pad=20)
CORR_CHANNELS = 441


class FlowNetC(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = conv(in_channels, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv3 = conv(128, 256, 5, 2)
        self.conv_redir = conv(256, 32, 1)
        self.conv3_1 = conv(CORR_CHANNELS + 32, 256, 3)
        self.conv4 = conv(256, 512, 3, 2)
        self.conv4_1 = conv(512, 512, 3)
        self.conv5 = conv(512, 512, 3, 2)
        self.conv5_1 = conv(512, 512, 3)
        self.conv6 = conv(512, 1024, 3, 2)
        self.conv6_1 = conv(1024, 1024, 3)
        add_refinement_decoder(self, feature_channels={6: 1024, 5: 512, 4: 512, 3: 256, 2: 128})

    def _tower(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        c2 = conv_block(self.conv2, head_block(self.conv1, x))
        return c2, conv_block(self.conv3, c2)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> dict[str, torch.Tensor]:
        """img0/img1: (N, 3, H, W) normalized -> {"flow2".."flow6"} (net units), NCHW."""
        c2a, c3a = self._tower(img0)
        _, c3b = self._tower(img1)
        corr = leaky_relu(correlation(c3a, c3b, **CORR_KWARGS))
        redir = conv_block(self.conv_redir, c3a)
        c3_1 = conv_block(self.conv3_1, torch.cat([corr, redir], dim=1))
        c4_1 = conv_block(self.conv4_1, conv_block(self.conv4, c3_1))
        c5_1 = conv_block(self.conv5_1, conv_block(self.conv5, c4_1))
        c6_1 = conv_block(self.conv6_1, conv_block(self.conv6, c5_1))
        return refinement_decoder(self, {6: c6_1, 5: c5_1, 4: c4_1, 3: c3_1, 2: c2a})


def flownet_c_apply(net: FlowNetC, img0: torch.Tensor, img1: torch.Tensor) -> dict[str, torch.Tensor]:
    """img0/img1: (N, H, W, 3) normalized -> {"flow2".."flow6"}, NHWC."""
    return {k: to_nhwc(v) for k, v in net(to_nchw(img0), to_nchw(img1)).items()}
