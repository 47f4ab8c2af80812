"""The FlowNet model family as ``nn.Module``s (NCHW inside).

Each net's ``*_apply`` function takes and returns NHWC, like the JAX
package's. Layer names follow the JAX parameter names, so the JAX package's
weights load through ``flownet2_tpu_torch.checkpoint``.
"""

from flownet2_tpu_torch.models.dispnet import DispNetC, dispnet_c_apply
from flownet2_tpu_torch.models.flownet2 import (
    DIV_FLOW,
    FlowNet2,
    flownet2_apply,
    flownet2_cs_apply,
    flownet2_css_apply,
    normalize_images,
)
from flownet2_tpu_torch.models.flownet_c import FlowNetC, flownet_c_apply
from flownet2_tpu_torch.models.flownet_s import FlowNetS, flownet_s_apply
from flownet2_tpu_torch.models.flownet_sd import FlowNetSD, flownet_sd_apply
from flownet2_tpu_torch.models.fusion import FlowNetFusion, fusion_apply

# model name (as the CLI takes it) -> net; FlowNet2-CS and -CSS carry the
# whole FlowNet2 weight set, as in the JAX package
NETS = {
    "flownets": FlowNetS,
    "flownetc": FlowNetC,
    "flownet2-sd": FlowNetSD,
    "flownet2-cs": FlowNet2,
    "flownet2-css": FlowNet2,
    "flownet2": FlowNet2,
    "dispnetc": DispNetC,
}

__all__ = [
    "NETS",
    "DIV_FLOW",
    "DispNetC",
    "FlowNet2",
    "FlowNetC",
    "FlowNetFusion",
    "FlowNetS",
    "FlowNetSD",
    "dispnet_c_apply",
    "flownet2_apply",
    "flownet2_cs_apply",
    "flownet2_css_apply",
    "flownet_c_apply",
    "flownet_s_apply",
    "flownet_sd_apply",
    "fusion_apply",
    "normalize_images",
]
