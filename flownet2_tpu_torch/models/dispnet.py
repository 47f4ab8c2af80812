"""DispNetC: the stereo/disparity sibling of FlowNetC (flownet2_tpu/models/dispnet.py).

Siamese conv1 (7x7/2, 64) and conv2 (5x5/2, 128) towers, the 1-D
correlation at the conv2 resolution (stride 4; max_displacement 40,
single_direction -1: 41 one-sided channels), leaky ReLU, a 1x1 conv_redir
branch (64 channels) on the left tower, the conv3..conv6_1 encoder on the
105 concatenated channels, and the refinement decoder with 1-channel
disparity predictions (``flow6``..``flow2``, the decoder's names, so the
multi-scale loss applies unchanged). conv1 is a plain convolution, as in
the JAX package (no head routing).
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch.models.common import (
    add_refinement_decoder,
    conv,
    conv_block,
    refinement_decoder,
    to_nchw,
    to_nhwc,
)
from flownet2_tpu_torch.ops.activations import leaky_relu
from flownet2_tpu_torch.ops.correlation import correlation_1d

CORR1D_KWARGS = dict(max_displacement=40, kernel_size=1, stride1=1, stride2=1, pad=40, single_direction=-1)
CORR1D_CHANNELS = 41


class DispNetC(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = conv(in_channels, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv_redir = conv(128, 64, 1)
        self.conv3 = conv(CORR1D_CHANNELS + 64, 256, 5, 2)
        self.conv3_1 = conv(256, 256, 3)
        self.conv4 = conv(256, 512, 3, 2)
        self.conv4_1 = conv(512, 512, 3)
        self.conv5 = conv(512, 512, 3, 2)
        self.conv5_1 = conv(512, 512, 3)
        self.conv6 = conv(512, 1024, 3, 2)
        self.conv6_1 = conv(1024, 1024, 3)
        add_refinement_decoder(self, feature_channels={6: 1024, 5: 512, 4: 512, 3: 256, 2: 128}, pred_channels=1)

    def _tower(self, x: torch.Tensor) -> torch.Tensor:
        return conv_block(self.conv2, conv_block(self.conv1, x))

    def forward(self, img_left: torch.Tensor, img_right: torch.Tensor) -> dict[str, torch.Tensor]:
        """img_left/right: (N, 3, H, W) normalized -> {"flow2".."flow6"}, 1-channel disparity, NCHW."""
        c2l = self._tower(img_left)
        c2r = self._tower(img_right)
        corr = leaky_relu(correlation_1d(c2l, c2r, **CORR1D_KWARGS))
        redir = conv_block(self.conv_redir, c2l)
        c3_1 = conv_block(self.conv3_1, conv_block(self.conv3, torch.cat([corr, redir], dim=1)))
        c4_1 = conv_block(self.conv4_1, conv_block(self.conv4, c3_1))
        c5_1 = conv_block(self.conv5_1, conv_block(self.conv5, c4_1))
        c6_1 = conv_block(self.conv6_1, conv_block(self.conv6, c5_1))
        return refinement_decoder(self, {6: c6_1, 5: c5_1, 4: c4_1, 3: c3_1, 2: c2l})


def dispnet_c_apply(net: DispNetC, img_left: torch.Tensor, img_right: torch.Tensor) -> dict[str, torch.Tensor]:
    """img_left/right: (N, H, W, 3) normalized -> {"flow2".."flow6"}, NHWC."""
    return {k: to_nhwc(v) for k, v in net(to_nchw(img_left), to_nchw(img_right)).items()}
