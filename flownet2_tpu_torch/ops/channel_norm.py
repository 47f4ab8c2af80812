"""ChannelNorm: per-pixel L2 norm over the channel axis.

Counterpart of flownet2_tpu/ops/channel_norm.py (reference
channel_norm_layer.cpp:55-69 forward, :124 backward). The backward is the
reference's epsilon-stabilised one, dx = g * x / (norm + 1e-9): plain
autograd of sqrt gives 0 * inf = NaN where a channel vector is exactly
zero, and under a joint loss that NaN would reach every weight upstream.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


class _ChannelNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        ctx.save_for_backward(x, norm)
        return norm

    @staticmethod
    def backward(ctx, grad):
        x, norm = ctx.saved_tensors
        return x * (grad / (norm + _EPS))


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 1, H, W): sqrt of the channel-wise sum of squares."""
    return _ChannelNorm.apply(x)
