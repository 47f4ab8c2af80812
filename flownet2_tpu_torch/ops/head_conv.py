"""The full-resolution head convolutions: k x k conv and k4/s2 deconv with
bias and an optional leaky ReLU.

Counterpart of flownet2_tpu/ops/s2d.py's ``conv2d_s2d``, ``deconv2d_s2d``
and ``_pallas_ok``, and of the TPU kernel they route to,
flownet2_tpu/ops/pallas/s2d_conv.py::matmul_conv_pallas (K3). The JAX
package evaluates these layers in a space-to-depth layout for the TPU's
matrix unit; the port computes the same function in the plain NCHW layout:

- ``head_conv2d``: a k x k conv, pad k//2, stride 1 or 2, plus bias;
- ``head_deconv2d``: the FlowNet deconv, k=4, s=2, p=1, plus bias;

each followed by leaky ReLU (slope 0.1) when ``leaky``. A CUDA tensor goes
to an autograd Function whose forward is the hand-written kernel (float32:
CUDA cores, csrc/head_conv.cu, on weights laid out by
:func:`pack_head_weight_f32`; bfloat16: tensor cores, csrc/head_conv_tc.cu,
on weights laid out by :func:`pack_head_weight`) and whose backward is
autograd through the plain version, as the JAX custom VJP runs the XLA
formulation backward (ops/s2d.py:345-357,375-385); a CPU tensor goes to the
plain version.
Which layers come here at all is :func:`use_head_kernel`'s decision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flownet2_tpu_torch import _build
from flownet2_tpu_torch.ops.activations import leaky_relu

# (kernel, stride) pairs the conv kernel covers: the nets' head layers
CONV_GEOMETRIES = ((3, 1), (3, 2), (7, 2))
MAX_CONV_COUT, MAX_DECONV_COUT = 64, 16
# full-resolution width above which the head layers take the kernel
HEAD_KERNEL_MIN_WIDTH = 512
# the bfloat16 kernel's widths: input channels per k16 step, output channels
# per n tile group (one, two or eight n8 tiles)
PACK_CIN, PACK_COUTS = 16, (8, 16, 64)
# the float32 kernel's channel blocks
PACK_COUTS_F32 = (4, 16, 64)


def use_head_kernel(device_type: str, full_res_width: int) -> bool:
    """Whether a head layer runs through the K3 kernel: on a CUDA tensor
    whose full-resolution width is above 512. flownet2_tpu/ops/s2d.py:283-298
    routes by the space-to-depth width (> 256), which is half of it. Below
    that width the layer stays with its ``nn.Module`` (cuDNN on the card)."""
    return device_type == "cuda" and full_res_width > HEAD_KERNEL_MIN_WIDTH


def head_conv2d(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, stride: int, leaky: bool
) -> torch.Tensor:
    """x (N,Cin,H,W), weight (Cout,Cin,k,k), bias (Cout) -> (N,Cout,Ho,Wo)."""
    if x.device.type == "cuda":
        return _HeadConvCuda.apply(x, weight, bias, stride, leaky)
    if x.device.type == "cpu":
        return head_conv2d_plain(x, weight, bias, stride=stride, leaky=leaky)
    raise ValueError(f"head_conv2d: unsupported device {x.device}")


def head_deconv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, leaky: bool) -> torch.Tensor:
    """x (N,Cin,H,W), weight (Cin,Cout,4,4), bias (Cout) -> (N,Cout,2H,2W)."""
    if x.device.type == "cuda":
        return _HeadDeconvCuda.apply(x, weight, bias, leaky)
    if x.device.type == "cpu":
        return head_deconv2d_plain(x, weight, bias, leaky=leaky)
    raise ValueError(f"head_deconv2d: unsupported device {x.device}")


def head_conv2d_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, stride: int, leaky: bool
) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` (pad k//2) and the leaky ReLU."""
    out = F.conv2d(x, weight, bias, stride=stride, padding=weight.shape[-1] // 2)
    return leaky_relu(out) if leaky else out


def head_deconv2d_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, leaky: bool) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv_transpose2d`` (k4, s2, p1) and the leaky ReLU."""
    out = F.conv_transpose2d(x, weight, bias, stride=2, padding=1)
    return leaky_relu(out) if leaky else out


def pack_head_weight(weight: torch.Tensor, *, deconv: bool) -> torch.Tensor:
    """The bfloat16 kernel's weight layout, (taps, cout_pad, cin_pad), zero in
    the padding: cout_pad is 8, 16 or 64 (the kernel's n-tile widths), cin_pad
    the next multiple of 16 (a k16 step per channel chunk).

    conv, weight (Cout, Cin, k, k): tap ky * k + kx holds weight[:, :, ky, kx].
    deconv, weight (Cin, Cout, 4, 4) (k4/s2/p1): output phase (py, px) of
    output (2m + py, 2n + px) is a 2x2 conv over input (m - 1 + py + a,
    n - 1 + px + b); tap (py * 2 + px) * 4 + a * 2 + b holds
    weight[:, :, 3 - py - 2a, 3 - px - 2b] transposed.

    A row of the matrix (cout_pad, taps * cin_pad) that this reshapes to,
    times the im2col columns in tap-major, channel-minor order, is the
    layer before bias. Packed anew on every call: training changes the
    weights."""
    if deconv:
        cin, cout = weight.shape[:2]
        # flipped, kernel index 3 - py - 2a becomes py + 2a: split it as (a, py)
        taps = weight.flip(2, 3).reshape(cin, cout, 2, 2, 2, 2).permute(3, 5, 2, 4, 1, 0)  # py, px, a, b, co, ci
    else:
        cout, cin, k, _ = weight.shape
        taps = weight.permute(2, 3, 0, 1)  # ky, kx, co, ci
    cout_pad = next(c for c in PACK_COUTS if c >= cout)
    cin_pad = -(-cin // PACK_CIN) * PACK_CIN
    packed = weight.new_zeros((taps.shape[:-2].numel(), cout_pad, cin_pad))
    packed.view(*taps.shape[:-2], cout_pad, cin_pad)[..., :cout, :cin] = taps
    return packed


def pack_head_weight_f32(weight: torch.Tensor, *, deconv: bool) -> torch.Tensor:
    """The float32 kernel's weight layout, (cin, taps, cout_pad), zero in the
    padding: cout_pad is 4, 16 or 64 (the kernel's channel block), so that
    one input channel chunk's weights are one contiguous run of 16-byte
    units. Taps are ordered as in :func:`pack_head_weight` (deconv: phase
    major). The matrix (cin * taps, cout_pad) that this reshapes to, times
    the im2col rows in channel-major, tap-minor order, is the layer before
    bias. Packed anew on every call: training changes the weights."""
    if deconv:
        cin, cout = weight.shape[:2]
        taps = weight.flip(2, 3).reshape(cin, cout, 2, 2, 2, 2).permute(0, 3, 5, 2, 4, 1)  # ci, py, px, a, b, co
    else:
        cout, cin, k, _ = weight.shape
        taps = weight.permute(1, 2, 3, 0)  # ci, ky, kx, co
    cout_pad = next(c for c in PACK_COUTS_F32 if c >= cout)
    packed = weight.new_zeros((cin, taps.shape[1:-1].numel(), cout_pad))
    packed.view(*taps.shape[:-1], cout_pad)[..., :cout] = taps
    return packed


def vjp_of_plain(plain, inputs, needs, grads, **kwargs):
    """Autograd through ``plain`` at ``inputs`` with output cotangents
    ``grads``: the gradients of the inputs flagged in ``needs``, None for
    the others. The backward of the kernels' autograd Functions."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves, **kwargs)
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grads))
    return tuple(next(got) if n else None for n in needs)


class _HeadConvCuda(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, leaky):
        x = x.contiguous()
        ctx.save_for_backward(x, weight, bias)
        ctx.conv = (stride, leaky)
        return head_conv2d_cuda(x, weight.contiguous(), bias.contiguous(), stride=stride, leaky=leaky)

    @staticmethod
    def backward(ctx, grad):
        stride, leaky = ctx.conv
        grads = vjp_of_plain(head_conv2d_plain, ctx.saved_tensors, ctx.needs_input_grad[:3], grad,
                              stride=stride, leaky=leaky)
        return grads + (None, None)


class _HeadDeconvCuda(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, leaky):
        x = x.contiguous()
        ctx.save_for_backward(x, weight, bias)
        ctx.leaky = leaky
        return head_deconv2d_cuda(x, weight.contiguous(), bias.contiguous(), leaky=leaky)

    @staticmethod
    def backward(ctx, grad):
        grads = vjp_of_plain(head_deconv2d_plain, ctx.saved_tensors, ctx.needs_input_grad[:3], grad,
                              leaky=ctx.leaky)
        return grads + (None,)


def check_cuda_inputs(name: str, **tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    all float32 or all bfloat16; returns that dtype."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} needs CUDA tensors on one device, got {key} on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != first.dtype:
            raise TypeError(f"{name}: {key} dtype {t.dtype}; need all float32 or all bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return first.dtype


def head_conv2d_cuda(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, stride: int, leaky: bool
) -> torch.Tensor:
    """Launch the conv kernel on the current stream: float32 on the CUDA
    cores (csrc/head_conv.cu, weight packed by :func:`pack_head_weight_f32`),
    bfloat16 on the tensor cores (csrc/head_conv_tc.cu, weight packed by
    :func:`pack_head_weight`).

    Takes contiguous CUDA tensors on one device, all float32 or all
    bfloat16: x (N,Cin,H,W), weight (Cout,Cin,k,k) with (k, stride) in
    :data:`CONV_GEOMETRIES` and Cout <= 64, bias (Cout). Raises on anything
    else."""
    dtype = check_cuda_inputs("head_conv2d_cuda", x=x, weight=weight, bias=bias)
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"need x (N,Cin,H,W) and weight (Cout,Cin,k,k), got {tuple(x.shape)}, {tuple(weight.shape)}")
    n, cin, h, w = x.shape
    cout, wcin, k, k2 = weight.shape
    if wcin != cin or k != k2 or tuple(bias.shape) != (cout,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not fit x {tuple(x.shape)}")
    if (k, stride) not in CONV_GEOMETRIES or not 1 <= cout <= MAX_CONV_COUT or n > 65535:
        raise ValueError(f"head_conv2d_cuda covers (k, stride) in {CONV_GEOMETRIES}, Cout <= {MAX_CONV_COUT} "
                         f"and N <= 65535, got k={k}, stride={stride}, Cout={cout}, N={n}")
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    out = torch.empty((n, cout, ho, wo), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    pack = pack_head_weight if dtype == torch.bfloat16 else pack_head_weight_f32
    weight = pack(weight, deconv=False)
    status = _build.library().fn2_head_conv(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), n, cin, h, w, cout, k, stride,
        int(leaky), _build.DTYPE_CODES[dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_status(status, "head_conv2d")
    head_conv2d_cuda.launches += 1
    return out


head_conv2d_cuda.launches = 0  # kernel launches since the last reset


def head_deconv2d_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, leaky: bool) -> torch.Tensor:
    """Launch the deconv kernel on the current stream: float32 on the CUDA
    cores (csrc/head_conv.cu, weight packed by :func:`pack_head_weight_f32`),
    bfloat16 on the tensor cores (csrc/head_conv_tc.cu, weight packed by
    :func:`pack_head_weight`).

    Takes contiguous CUDA tensors on one device, all float32 or all
    bfloat16: x (N,Cin,H,W), weight (Cin,Cout,4,4) with Cout <= 16, bias
    (Cout). Raises on anything else."""
    dtype = check_cuda_inputs("head_deconv2d_cuda", x=x, weight=weight, bias=bias)
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"need x (N,Cin,H,W) and weight (Cin,Cout,4,4), got {tuple(x.shape)}, {tuple(weight.shape)}")
    n, cin, h, w = x.shape
    wcin, cout, k, k2 = weight.shape
    if wcin != cin or (k, k2) != (4, 4) or tuple(bias.shape) != (cout,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= cout <= MAX_DECONV_COUT or n > 65535:
        raise ValueError(f"head_deconv2d_cuda covers Cout <= {MAX_DECONV_COUT} and N <= 65535, got Cout={cout}, N={n}")
    out = torch.empty((n, cout, 2 * h, 2 * w), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    pack = pack_head_weight if dtype == torch.bfloat16 else pack_head_weight_f32
    weight = pack(weight, deconv=True)
    status = _build.library().fn2_head_deconv(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), n, cin, h, w, cout, int(leaky),
        _build.DTYPE_CODES[dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_status(status, "head_deconv2d")
    head_deconv2d_cuda.launches += 1
    return out


head_deconv2d_cuda.launches = 0  # kernel launches since the last reset


def head_launches() -> int:
    """Launches of K3's two kernels (conv and deconv) since their last reset."""
    return head_conv2d_cuda.launches + head_deconv2d_cuda.launches
