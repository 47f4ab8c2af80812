"""FlowNetS: the simple encoder-decoder flow net (flownet2_tpu/models/flownet_s.py).

10-conv encoder (7x7/5x5 stride-2 head down to stride 64) + refinement
decoder with per-scale flow predictions. Used standalone and, with
12-channel inputs, as the S1/S2 stages of the FlowNet2 cascade.
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

ENCODER_CHANNELS = {
    "conv1": (7, 64, 2),
    "conv2": (5, 128, 2),
    "conv3": (5, 256, 2),
    "conv3_1": (3, 256, 1),
    "conv4": (3, 512, 2),
    "conv4_1": (3, 512, 1),
    "conv5": (3, 512, 2),
    "conv5_1": (3, 512, 1),
    "conv6": (3, 1024, 2),
    "conv6_1": (3, 1024, 1),
}


class FlowNetS(nn.Module):
    def __init__(self, in_channels: int = 6):
        super().__init__()
        cin = in_channels
        for name, (k, cout, stride) in ENCODER_CHANNELS.items():
            self.add_module(name, conv(cin, cout, k, stride))
            cin = cout
        add_refinement_decoder(self, feature_channels={6: 1024, 5: 512, 4: 512, 3: 256, 2: 128})

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, C, H, W) stacked inputs -> {"flow2".."flow6"} (net units), NCHW."""
        feats = {}
        out = x
        for name in ENCODER_CHANNELS:
            block = head_block if name == "conv1" else conv_block  # the full-resolution head
            out = block(getattr(self, name), out)
            feats[name] = out
        return refinement_decoder(
            self,
            {6: feats["conv6_1"], 5: feats["conv5_1"], 4: feats["conv4_1"],
             3: feats["conv3_1"], 2: feats["conv2"]},
        )


def flownet_s_apply(net: FlowNetS, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x: (N, H, W, C) -> {"flow2".."flow6"}, each (N, h, w, 2) NHWC."""
    return {k: to_nhwc(v) for k, v in net(to_nchw(x)).items()}
