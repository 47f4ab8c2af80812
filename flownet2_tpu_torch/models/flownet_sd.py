"""FlowNet2-SD: the small-displacement net (flownet2_tpu/models/flownet_sd.py).

All-3x3 encoder with an extra stride-1 conv0 and doubled conv*_1 layers,
and a decoder with ``inter_conv`` layers between deconv and flow
prediction. conv0 and conv1, the full-resolution head, go through
``head_block``.
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch.models.common import conv, conv_block, deconv, head_block, to_nchw, to_nhwc

ENCODER = (  # name, cin, cout, stride
    ("conv0", None, 64, 1),
    ("conv1", 64, 64, 2),
    ("conv1_1", 64, 128, 1),
    ("conv2", 128, 128, 2),
    ("conv2_1", 128, 128, 1),
    ("conv3", 128, 256, 2),
    ("conv3_1", 256, 256, 1),
    ("conv4", 256, 512, 2),
    ("conv4_1", 512, 512, 1),
    ("conv5", 512, 512, 2),
    ("conv5_1", 512, 512, 1),
    ("conv6", 512, 1024, 2),
    ("conv6_1", 1024, 1024, 1),
)
# level: (deconv input channels, deconv output channels, skip channels)
DECODER = {5: (1024, 512, 512), 4: (1026, 256, 512), 3: (770, 128, 256), 2: (386, 64, 128)}
SKIPS = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2_1"}
HEAD = ("conv0", "conv1")  # the full-resolution head


class FlowNetSD(nn.Module):
    def __init__(self, in_channels: int = 6):
        super().__init__()
        for name, cin, cout, stride in ENCODER:
            self.add_module(name, conv(in_channels if cin is None else cin, cout, 3, stride))
        self.predict_flow6 = conv(1024, 2, 3)
        for lvl, (cin, dc, skip_c) in DECODER.items():
            link_c = skip_c + dc + 2
            self.add_module(f"deconv{lvl}", deconv(cin, dc))
            self.add_module(f"upsample_flow{lvl + 1}to{lvl}", deconv(2, 2))
            self.add_module(f"inter_conv{lvl}", conv(link_c, dc, 3))
            self.add_module(f"predict_flow{lvl}", conv(dc, 2, 3))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, 6, H, W) stacked normalized pair -> {"flow2".."flow6"}, NCHW."""
        feats = {}
        out = x
        for name, *_ in ENCODER:
            block = head_block if name in HEAD else conv_block
            out = block(getattr(self, name), out)
            feats[name] = out
        flow = conv_block(self.predict_flow6, out, relu=False)
        flows = {"flow6": flow}
        link = out
        for lvl in DECODER:
            up_feat = conv_block(getattr(self, f"deconv{lvl}"), link)
            up_flow = conv_block(getattr(self, f"upsample_flow{lvl + 1}to{lvl}"), flow, relu=False)
            link = torch.cat([feats[SKIPS[lvl]], up_feat, up_flow], dim=1)
            inter = conv_block(getattr(self, f"inter_conv{lvl}"), link, relu=False)
            flow = conv_block(getattr(self, f"predict_flow{lvl}"), inter, relu=False)
            flows[f"flow{lvl}"] = flow
        return flows


def flownet_sd_apply(net: FlowNetSD, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x: (N, H, W, 6) -> {"flow2".."flow6"}, NHWC."""
    return {k: to_nhwc(v) for k, v in net(to_nchw(x)).items()}
