"""The fusion net's decoder head as one function of (concat1, c0).

Counterpart of flownet2_tpu/ops/s2d.py:422-500 (``fusion_head``,
``_fusion_head_xla``) and of the TPU kernel
flownet2_tpu/ops/pallas/fusion_head.py::fusion_head_pallas (K4):

    inter1 = inter_conv1(concat1)          162 -> 32, 3x3
    flow1  = predict_flow1(inter1)          32 ->  2, 3x3
    upfeat = leaky(deconv0(concat1))       162 -> 16, k4/s2
    upflow = upsample_flow1to0(flow1)        2 ->  2, k4/s2
    inter0 = inter_conv0([c0|upfeat|upflow]) 82 -> 16, 3x3
    flow0  = predict_flow0(inter0)          16 ->  2, 3x3

concat1 (N,162,H/2,W/2) and c0 (N,64,H,W) -> flow0 (N,2,H,W), flow1
(N,2,H/2,W/2). A CUDA tensor goes to an autograd Function whose forward is
the hand-written kernel (one launch: float32 on the CUDA cores,
csrc/fusion_head.cu; bfloat16 on the tensor cores, csrc/fusion_head_tc.cu;
both on weights laid out by :func:`pack_fusion_head_weights`) and whose
backward is autograd through the plain version, the JAX custom VJP's
policy (ops/s2d.py:479-491); a CPU tensor goes to :func:`fusion_head_plain`.
The fusion net takes this path only when built with ``fusion_head=True``
(the JAX package's ``FLOWNET2_TPU_FUSION_HEAD=1``).
"""

from __future__ import annotations

import torch
from torch import nn

from flownet2_tpu_torch import _build
from flownet2_tpu_torch.ops.head_conv import (
    check_cuda_inputs,
    head_conv2d_plain,
    head_deconv2d_plain,
    pack_head_weight,
    pack_head_weight_f32,
    vjp_of_plain,
)

# the head's layers, in the kernel's argument order
LAYERS = ("inter_conv1", "predict_flow1", "deconv0", "upsample_flow1to0", "inter_conv0", "predict_flow0")
# weight shapes: conv (Cout, Cin, 3, 3), deconv (Cin, Cout, 4, 4)
WEIGHT_SHAPES = ((32, 162, 3, 3), (2, 32, 3, 3), (162, 16, 4, 4), (2, 2, 4, 4), (16, 82, 3, 3), (2, 16, 3, 3))
CONCAT1_CHANNELS, C0_CHANNELS = 162, 64


def head_weights(net: nn.Module) -> tuple[torch.Tensor, ...]:
    """(weight, bias) of each layer in :data:`LAYERS`, flat, from a fusion net."""
    return tuple(t for name in LAYERS for t in (getattr(net, name).weight, getattr(net, name).bias))


def pack_fusion_head_weights(*weights: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """:func:`head_weights`' twelve tensors with each weight in the layout
    the kernel of its dtype reads; biases as they are.

    bfloat16 (tensor cores): the five convolutions as
    :func:`~flownet2_tpu_torch.ops.head_conv.pack_head_weight` lays them out,
    (taps, cout_pad, cin_pad) with cin_pad a multiple of 16, inter_conv1 kept
    at its 32 output channels: (9, 32, 176), (9, 8, 32), deconv0 (16, 16,
    176), inter_conv0 (9, 16, 96), (9, 8, 16). float32 (CUDA cores): as
    :func:`~flownet2_tpu_torch.ops.head_conv.pack_head_weight_f32`, (cin,
    taps, cout_pad): (162, 9, 32), (32, 9, 4), (162, 16, 16), (82, 9, 16),
    (16, 9, 4). upsample_flow1to0, which both kernels run on the CUDA cores,
    as pack_head_weight_f32 in both: (2, 16, 4). Packed anew on every call:
    training changes the weights."""
    w_i1, b_i1, w_pf1, b_pf1, w_dc, b_dc, w_up, b_up, w_i0, b_i0, w_pf0, b_pf0 = weights
    bf16 = w_i1.dtype == torch.bfloat16
    pack = pack_head_weight if bf16 else pack_head_weight_f32
    i1 = pack(w_i1, deconv=False)  # 32 output channels pad to 64 there
    i1 = (i1[:, :32] if bf16 else i1[..., :32]).contiguous()
    return (
        i1, b_i1, pack(w_pf1, deconv=False), b_pf1, pack(w_dc, deconv=True), b_dc,
        pack_head_weight_f32(w_up, deconv=True), b_up, pack(w_i0, deconv=False), b_i0, pack(w_pf0, deconv=False),
        b_pf0,
    )


def fusion_head(concat1: torch.Tensor, c0: torch.Tensor, net: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """(concat1, c0, fusion net) -> (flow0, flow1)."""
    weights = head_weights(net)
    if concat1.device.type == "cuda":
        return _FusionHeadCuda.apply(concat1, c0, *weights)
    if concat1.device.type == "cpu":
        return fusion_head_plain(concat1, c0, *weights)
    raise ValueError(f"fusion_head: unsupported device {concat1.device}")


def fusion_head_plain(
    concat1: torch.Tensor, c0: torch.Tensor, *weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the six layers' plain versions in a row (the
    counterpart of ``_fusion_head_xla``). ``weights`` as :func:`head_weights`."""
    w_i1, b_i1, w_pf1, b_pf1, w_dc, b_dc, w_up, b_up, w_i0, b_i0, w_pf0, b_pf0 = weights
    inter1 = head_conv2d_plain(concat1, w_i1, b_i1, stride=1, leaky=False)
    flow1 = head_conv2d_plain(inter1, w_pf1, b_pf1, stride=1, leaky=False)
    up_feat = head_deconv2d_plain(concat1, w_dc, b_dc, leaky=True)
    up_flow = head_deconv2d_plain(flow1, w_up, b_up, leaky=False)
    inter0 = head_conv2d_plain(torch.cat([c0, up_feat, up_flow], dim=1), w_i0, b_i0, stride=1, leaky=False)
    return head_conv2d_plain(inter0, w_pf0, b_pf0, stride=1, leaky=False), flow1


class _FusionHeadCuda(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, concat1, c0, *weights):
        concat1, c0 = concat1.contiguous(), c0.contiguous()
        ctx.save_for_backward(concat1, c0, *weights)
        return fusion_head_cuda(concat1, c0, *(w.contiguous() for w in weights))

    @staticmethod
    def backward(ctx, grad0, grad1):
        return vjp_of_plain(fusion_head_plain, ctx.saved_tensors, ctx.needs_input_grad, (grad0, grad1))


def fusion_head_cuda(
    concat1: torch.Tensor, c0: torch.Tensor, *weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: float32 on the CUDA cores
    (csrc/fusion_head.cu), bfloat16 on the tensor cores
    (csrc/fusion_head_tc.cu), each on weights packed by
    :func:`pack_fusion_head_weights`.

    Takes contiguous CUDA tensors on one device, all float32 or all
    bfloat16: concat1 (N,162,H2,W2), c0 (N,64,2 H2,2 W2) and the twelve
    weights and biases of :func:`head_weights`. Returns (flow0 (N,2,2 H2,2 W2),
    flow1 (N,2,H2,W2)). Raises on anything else."""
    if len(weights) != 2 * len(LAYERS):
        raise ValueError(f"fusion_head_cuda needs {2 * len(LAYERS)} weights and biases, got {len(weights)}")
    named = {"concat1": concat1, "c0": c0}
    for name, w, b in zip(LAYERS, weights[::2], weights[1::2]):
        named[f"{name}.weight"], named[f"{name}.bias"] = w, b
    dtype = check_cuda_inputs("fusion_head_cuda", **named)
    for name, w, b, shape in zip(LAYERS, weights[::2], weights[1::2], WEIGHT_SHAPES):
        cout = shape[1] if name in ("deconv0", "upsample_flow1to0") else shape[0]
        if tuple(w.shape) != shape or tuple(b.shape) != (cout,):
            raise ValueError(f"fusion_head_cuda: {name} weight {tuple(w.shape)} / bias {tuple(b.shape)}, "
                             f"expected {shape} / ({cout},)")
    if concat1.dim() != 4 or concat1.shape[1] != CONCAT1_CHANNELS:
        raise ValueError(f"concat1 must be (N, {CONCAT1_CHANNELS}, H2, W2), got {tuple(concat1.shape)}")
    n, _, h2, w2 = concat1.shape
    if tuple(c0.shape) != (n, C0_CHANNELS, 2 * h2, 2 * w2) or n > 65535:
        raise ValueError(f"c0 {tuple(c0.shape)} does not fit concat1 {tuple(concat1.shape)} (or N > 65535)")
    flow0 = torch.empty((n, 2, 2 * h2, 2 * w2), dtype=dtype, device=concat1.device)
    flow1 = torch.empty((n, 2, h2, w2), dtype=dtype, device=concat1.device)
    if flow1.numel() == 0:
        return flow0, flow1
    packed = pack_fusion_head_weights(*weights)
    status = _build.library().fn2_fusion_head(
        concat1.data_ptr(), c0.data_ptr(), *(t.data_ptr() for t in packed), flow0.data_ptr(), flow1.data_ptr(),
        n, h2, w2, _build.DTYPE_CODES[dtype], torch.cuda.current_stream(concat1.device).cuda_stream,
    )
    _build.check_status(status, "fusion_head")
    fusion_head_cuda.launches += 1
    return flow0, flow1


fusion_head_cuda.launches = 0  # kernel launches since the last reset
