"""The TPU's default float32 convolution arithmetic on any device, for
diagnosis: off every default path of the port.

XLA on a TPU computes a float32 convolution at its default precision as one
bfloat16 pass: both operands rounded to bfloat16, their products summed in
float32. The JAX package's training runs on the TPU (``runs/synth/
run_r5.sh``) and their held-out scoring computed their convolutions and
deconvolutions so, while its leaky ReLU, losses and downsample ran at
``precision="highest"`` or elementwise, and Adam in float32.

- :class:`BF16PassConv`: an autograd Function for ``conv2d`` and
  ``conv_transpose2d``. The forward rounds the input and the weight to
  bfloat16 (round to nearest even), convolves them in float32 and adds
  the bias in float32. The backward computes d_input and d_weight the
  same way, from the bfloat16-rounded cotangent and the other rounded
  operand, with float32 sums; d_bias is the float32 sum of the cotangent.
  The product of two bfloat16 values is exact in float32, so the result
  is the TPU's only where nothing else rounds: turn cuDNN's TF32 off in
  the process (``torch.backends.cudnn.allow_tf32 = False``).
- :func:`route_convs` sends every ``nn.Conv2d`` and ``nn.ConvTranspose2d``
  of a net through it (every layer ``models/common.py``'s ``conv`` and
  ``deconv`` build), on that net alone. The parameters and the
  ``state_dict`` stay as they are. A full-resolution head layer that
  ``head_block`` hands to K3 (on a card, above width 512) bypasses the
  module and keeps K3's arithmetic; FlowNetS at 448x320 and 512x384 never
  reaches it.

``scripts/convergence_runs.py --r5-arm tpu`` trains and scores the
run_r5.sh recipe with it.
"""

from __future__ import annotations

import types

import torch
from torch import nn

_CONVS = (nn.Conv2d, nn.ConvTranspose2d)


class BF16PassConv(torch.autograd.Function):
    """``conv2d`` (``transposed`` False) or ``conv_transpose2d`` on
    bfloat16-rounded operands with float32 sums and a float32 bias.
    ``geometry``: (stride, padding, dilation, transposed, output_padding,
    groups), as ``aten.convolution`` takes them."""

    @staticmethod
    def forward(ctx, x, weight, bias, geometry):
        if x.dtype != torch.float32 or weight.dtype != torch.float32:
            raise TypeError(f"BF16PassConv computes float32 convolutions, got {x.dtype} / {weight.dtype}")
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.geometry = geometry
        out = torch.ops.aten.convolution(xb.float(), wb.float(), None, *geometry)
        if bias is not None:
            out = out + bias.view(1, -1, 1, 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        xb, wb = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x or need_w:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad.to(torch.bfloat16).float(), xb.float(), wb.float(), None, *ctx.geometry, [need_x, need_w, False]
            )
        if need_b:
            db = grad.sum(dim=(0, 2, 3))
        return dx, dw, db, None


def _geometry(layer: nn.Conv2d | nn.ConvTranspose2d) -> tuple:
    if layer.padding_mode != "zeros" or isinstance(layer.padding, str):
        raise ValueError(f"{layer}: only zero padding given as numbers is routed")
    transposed = isinstance(layer, nn.ConvTranspose2d)
    output_padding = layer.output_padding if transposed else (0, 0)
    return (layer.stride, layer.padding, layer.dilation, transposed, output_padding, layer.groups)


def _routed_forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
    if output_size is not None:
        raise ValueError("the bfloat16-pass deconvolution takes no output_size")
    return BF16PassConv.apply(x, self.weight, self.bias, _geometry(self))


def route_convs(net: nn.Module) -> int:
    """Route every ``nn.Conv2d`` and ``nn.ConvTranspose2d`` of ``net``
    through :class:`BF16PassConv`; returns how many were routed."""
    n = 0
    for layer in net.modules():
        if isinstance(layer, _CONVS):
            _geometry(layer)  # refuse what the route cannot compute now, not at the first forward
            layer.forward = types.MethodType(_routed_forward, layer)
            n += 1
    return n
