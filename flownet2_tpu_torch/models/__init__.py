"""The FlowNet model family, and RAFT, as ``nn.Module``s (NCHW inside).

Each FlowNet net's ``*_apply`` function takes and returns NHWC, like the JAX
package's. Layer names follow the JAX parameter names, so the JAX package's
weights load through ``flownet2_tpu_torch.checkpoint``, and so do the
reference's Caffe weights through ``import_caffe`` (``export_caffe`` writes
them back). RAFT (``models/raft.py``) has no JAX or Caffe counterpart; its
layer names are the published PyTorch code's.
"""

from flownet2_tpu_torch.models.dispnet import DispNetC, dispnet_c_apply
from flownet2_tpu_torch.models.export_caffe import (
    export_caffemodel,
    export_caffemodel_h5,
    export_caffemodel_merged,
    export_caffemodel_merged_h5,
)
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
from flownet2_tpu_torch.models.import_caffe import import_caffemodel, parse_caffemodel, parse_caffemodel_h5
from flownet2_tpu_torch.models.raft import RAFT

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
# every model the port runs: the FlowNet family (the JAX package's too) and RAFT
MODELS = {**NETS, "raft": RAFT}

__all__ = [
    "MODELS",
    "NETS",
    "DIV_FLOW",
    "DispNetC",
    "FlowNet2",
    "FlowNetC",
    "FlowNetFusion",
    "FlowNetS",
    "FlowNetSD",
    "RAFT",
    "dispnet_c_apply",
    "export_caffemodel",
    "export_caffemodel_h5",
    "export_caffemodel_merged",
    "export_caffemodel_merged_h5",
    "flownet2_apply",
    "flownet2_cs_apply",
    "flownet2_css_apply",
    "flownet_c_apply",
    "flownet_s_apply",
    "flownet_sd_apply",
    "fusion_apply",
    "import_caffemodel",
    "normalize_images",
    "parse_caffemodel",
    "parse_caffemodel_h5",
]
