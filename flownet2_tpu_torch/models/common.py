"""Shared building blocks for the FlowNet encoders and decoders.

Counterpart of flownet2_tpu/models/common.py, in the plain NCHW layout.
Layers are registered on the net under the JAX parameter names, so a
``state_dict`` key ``conv1.weight`` is the JAX ``conv1/w``. The
full-resolution head layers go through :func:`head_block`, the counterpart
of ``strided_head_block`` and of the JAX nets' other ``conv2d_s2d`` /
``deconv2d_s2d`` calls: the same function, on the K3 kernel where the JAX
package routes its TPU kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch.ops import head_conv
from flownet2_tpu_torch.ops.activations import leaky_relu


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    """Caffe-style conv with 'same' padding k//2 (out = floor((in+2p-k)/s)+1)."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The FlowNet deconvolution: k=4, s=2, p=1 (out = 2*in)."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def conv_block(layer: nn.Module, x: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """A conv or deconv layer, then leaky ReLU (slope 0.1) unless ``relu`` is False.
    Serves as both ``conv_block`` and ``deconv_block`` of the JAX package."""
    out = layer(x)
    return leaky_relu(out) if relu else out


def head_block(layer: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """:func:`conv_block` for a full-resolution head layer (a 3x3 or 7x7 conv,
    stride 1 or 2, or the k4/s2 deconv): on the K3 kernel with bias and leaky
    ReLU fused when :func:`head_conv.use_head_kernel` says so, else the
    layer itself. The routing width is the layer's full-resolution width:
    a conv's input width, a deconv's output width."""
    deconv_layer = isinstance(layer, nn.ConvTranspose2d)
    width = 2 * x.shape[-1] if deconv_layer else x.shape[-1]
    if not head_conv.use_head_kernel(x.device.type, width):
        return conv_block(layer, x, relu=relu)
    if deconv_layer:
        return head_conv.head_deconv2d(x, layer.weight, layer.bias, leaky=relu)
    return head_conv.head_conv2d(x, layer.weight, layer.bias, stride=layer.stride[0], leaky=relu)


def add_refinement_decoder(
    net: nn.Module,
    feature_channels: dict[int, int],
    *,
    levels: tuple[int, ...] = (6, 5, 4, 3, 2),
    deconv_channels: dict[int, int] | None = None,
    pred_channels: int = 2,
) -> None:
    """Register the layers of :func:`refinement_decoder` on ``net``."""
    if deconv_channels is None:
        deconv_channels = {5: 512, 4: 256, 3: 128, 2: 64}
    top = levels[0]
    net.add_module(f"predict_flow{top}", conv(feature_channels[top], pred_channels, 3))
    link_c = feature_channels[top]
    for lvl in levels[1:]:
        dc = deconv_channels[lvl]
        net.add_module(f"deconv{lvl}", deconv(link_c, dc))
        net.add_module(f"upsample_flow{lvl + 1}to{lvl}", deconv(pred_channels, pred_channels))
        link_c = feature_channels[lvl] + dc + pred_channels
        net.add_module(f"predict_flow{lvl}", conv(link_c, pred_channels, 3))


def refinement_decoder(
    net: nn.Module, features: dict[int, torch.Tensor], *, levels: tuple[int, ...] = (6, 5, 4, 3, 2)
) -> dict[str, torch.Tensor]:
    """The FlowNetS/C refinement decoder: per level predict flow, deconv the
    features, deconv-upsample the flow, concat with the skip feature.
    ``features[l]`` is the encoder activation at stride 2**l. Returns
    {"flow6".."flow2"} in net units (flow/20), NCHW."""
    top = levels[0]
    flow = conv_block(getattr(net, f"predict_flow{top}"), features[top], relu=False)
    flows = {f"flow{top}": flow}
    link = features[top]
    for lvl in levels[1:]:
        up_feat = conv_block(getattr(net, f"deconv{lvl}"), link)
        up_flow = conv_block(getattr(net, f"upsample_flow{lvl + 1}to{lvl}"), flow, relu=False)
        link = torch.cat([features[lvl], up_feat, up_flow], dim=1)
        flow = conv_block(getattr(net, f"predict_flow{lvl}"), link, relu=False)
        flows[f"flow{lvl}"] = flow
    return flows
