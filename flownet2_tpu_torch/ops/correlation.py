"""Correlation (cost volume), the FlowNetC operator.

Counterpart of flownet2_tpu/ops/correlation.py (``correlation`` and
``correlation_auto``; reference correlation_layer.{cpp,cu}):

- both inputs are zero-padded by ``pad`` on each spatial side;
- kernel radius kr = (k-1)//2, border b = max_displacement + kr,
  out_h = ceil((H + 2*pad - 2*b) / stride1) (same for W),
  grid radius gr = max_displacement // stride2, gw = 2*gr + 1 channels per
  axis, gw**2 output channels;
- output channel d is the displacement ((d//gw - gr)*stride2,
  (d%gw - gr)*stride2), y-major;
- multiply mode: the mean over the k*k*C window of f1 * f2; subtract mode:
  the mean of |f1 - f2| over the same window.

Layout: f1, f2 (N, C, H, W) -> (N, gw**2, out_h, out_w). On CUDA tensors
the FlowNet configuration (multiply, k=1, stride1=1, pad ==
max_displacement) goes to an autograd Function over the hand-written
kernels (forward csrc/correlation.cu, backward csrc/correlation_bwd.cu;
ValueError where a kernel's wrapper refuses a shape, and a kernel that
fails to build or launch raises: nothing falls back). Every other
configuration, on the card as on the CPU, goes to
:func:`correlation_plain`, torch ops that autograd differentiates, as the
JAX package sends those configurations to its general XLA scan. The choice
is made from the configuration alone.

The 1-D (stereo) correlation of DispNetC (``correlation_1d``; reference
correlation_layer1d.{cpp,cu}) pads the width only, has no vertical
displacement, and searches one side (``single_direction`` -1 / +1: gr + 1
channels) or both (0: 2*gr + 1). Its CUDA kernels (csrc/correlation1d.cu,
csrc/correlation1d_bwd.cu) take DispNet's configuration (multiply, k=1,
stride1=1, pad == max_displacement) on the nets' NCHW tensors directly;
:func:`correlation_1d_plain` computes every other configuration, on the
card and on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from flownet2_tpu_torch import _build


def correlation_output_shape(
    height: int, width: int, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0,
) -> tuple[int, int, int]:
    """(out_h, out_w, out_channels) per correlation_layer.cpp:56-70."""
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    out_h = math.ceil((height + 2 * pad - 2 * border) / stride1)
    out_w = math.ceil((width + 2 * pad - 2 * border) / stride1)
    gw = 2 * (max_displacement // stride2) + 1
    return out_h, out_w, gw * gw


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0, multiply: bool = True,
) -> torch.Tensor:
    """Cost volume of f1 vs f2, both (N, C, H, W) -> (N, gw**2, out_h, out_w)."""
    kernel = multiply and kernel_size == 1 and stride1 == 1 and pad == max_displacement
    if f1.device.type == "cuda" and kernel:
        return _CorrelationCuda.apply(f1, f2, max_displacement, stride2)
    if f1.device == f2.device and f1.device.type in ("cuda", "cpu"):
        return correlation_plain(
            f1, f2, max_displacement=max_displacement, kernel_size=kernel_size,
            stride1=stride1, stride2=stride2, pad=pad, multiply=multiply,
        )
    raise ValueError(f"correlation: unsupported devices {f1.device} / {f2.device}")


class _CorrelationCuda(torch.autograd.Function):
    """The CUDA kernels under autograd. The forward's channels-last copies
    are what the backward kernel reads, so they are saved, not made again."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2):
        # the kernels read channels-last; a channels_last input is not copied
        f1c, f2c = f1.permute(0, 2, 3, 1).contiguous(), f2.permute(0, 2, 3, 1).contiguous()
        ctx.save_for_backward(f1c, f2c)
        ctx.corr = (max_displacement, stride2)
        return correlation_cuda(f1c, f2c, max_displacement=max_displacement, stride2=stride2)

    @staticmethod
    def backward(ctx, grad):
        f1c, f2c = ctx.saved_tensors
        md, stride2 = ctx.corr
        need_f1, need_f2, _, _ = ctx.needs_input_grad
        df1, df2 = correlation_backward_cuda(
            f1c, f2c, grad.to(f1c.dtype).contiguous(), max_displacement=md, stride2=stride2,
            need_f1=need_f1, need_f2=need_f2,
        )
        # back to the nets' (N, C, H, W), as views of the channels-last results
        return tuple(None if d is None else d.permute(0, 3, 1, 2) for d in (df1, df2)) + (None, None)


def correlation_plain(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0, multiply: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: a loop over the displacements of padded,
    shifted slices with a channel mean, in float32."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd (correlation_layer.cpp:22)")
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"need two equal (N, C, H, W) inputs, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    n, c, h, w = f1.shape
    md = max_displacement
    out_h, out_w, _ = correlation_output_shape(
        h, w, max_displacement=md, kernel_size=kernel_size, stride1=stride1,
        stride2=stride2, pad=pad,
    )
    if out_h < 1 or out_w < 1:
        raise ValueError("correlation window does not fit in input")
    gr = md // stride2
    f1p = F.pad(f1.float(), (pad, pad, pad, pad))
    f2p = F.pad(f2.float(), (pad, pad, pad, pad))
    # patch origins in padded coordinates: rows md .. md + (out_h-1)*s1 + k-1
    span_h = (out_h - 1) * stride1 + kernel_size
    span_w = (out_w - 1) * stride1 + kernel_size
    a = f1p[:, :, md:md + span_h, md:md + span_w]
    box = torch.ones(1, 1, kernel_size, kernel_size, dtype=torch.float32, device=f1.device)
    outs = []
    for p in range(-gr, gr + 1):
        dy = p * stride2
        for o in range(-gr, gr + 1):
            dx = o * stride2
            b = f2p[:, :, md + dy:md + dy + span_h, md + dx:md + dx + span_w]
            q = (a * b).sum(dim=1) if multiply else (a - b).abs().sum(dim=1)
            if kernel_size > 1:
                q = F.conv2d(q[:, None], box)[:, 0]
            outs.append(q[:, ::stride1, ::stride1])
    out = torch.stack(outs, dim=1) / (kernel_size * kernel_size * c)
    return out.to(f1.dtype)


def correlation_cuda(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, stride2: int
) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/correlation.cu) on the current stream.

    FlowNet configuration only (multiply, k=1, stride1=1, pad=max_displacement).
    Takes f1, f2 (N, H, W, C) channels-last, contiguous, float32 or bfloat16
    (then with C even: the kernel copies 4 bytes at a time), on one CUDA
    device; returns (N, gw**2, H, W) in their dtype. Raises on anything else,
    and where a block's staged rows (the whole width, with its halo) do not
    fit shared memory: W above about 900.
    """
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation_cuda needs CUDA tensors on one device, got {f1.device} / {f2.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two equal (N, H, W, C) inputs, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"correlation_cuda: dtypes {f1.dtype} / {f2.dtype}; need both float32 or both bfloat16")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation_cuda: inputs must be contiguous (N, H, W, C)")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"bad max_displacement={max_displacement} / stride2={stride2}")
    n, h, w, c = f1.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"correlation_cuda: N={n} and H={h} must each be <= 65535 (grid limits)")
    if f1.dtype == torch.bfloat16 and c % 2:
        raise ValueError(f"correlation_cuda: bfloat16 needs an even channel count, got C={c}")
    gw = 2 * (max_displacement // stride2) + 1
    out = torch.empty((n, gw * gw, h, w), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    status = lib.fn2_correlation(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c, max_displacement, stride2,
        _build.DTYPE_CODES[f1.dtype], torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _build.check_status(status, "correlation")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0  # kernel launches since the last reset


def correlation_backward_plain(
    f1: torch.Tensor, f2: torch.Tensor, grad: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP: autograd through :func:`correlation_plain` with the
    same keyword arguments. f1, f2 (N, C, H, W), grad the cotangent of the
    output; returns (df1, df2) (N, C, H, W) in the inputs' dtype."""
    with torch.enable_grad():
        a = f1.detach().requires_grad_(True)
        b = f2.detach().requires_grad_(True)
        out = correlation_plain(a, b, **kwargs)
        df1, df2 = torch.autograd.grad(out, (a, b), grad.to(out.dtype))
    return df1, df2


def correlation_backward_cuda(
    f1: torch.Tensor, f2: torch.Tensor, grad: torch.Tensor, *, max_displacement: int, stride2: int,
    need_f1: bool = True, need_f2: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Launch the backward kernel (csrc/correlation_bwd.cu) on the current stream.

    FlowNet configuration only. Takes f1, f2 (N, H, W, C) channels-last and
    grad (N, gw**2, H, W), contiguous, all float32 or all bfloat16 (then
    with C even: the kernel copies 4 bytes at a time), on one CUDA device;
    returns (df1, df2) (N, H, W, C) in their dtype, None for a gradient not
    asked for. Both gradients are one launch. Raises on anything else, on
    gw * H * W >= 2**31 for gw = 2 * (max_displacement // stride2) + 1
    (32-bit offsets into a g plane), and where the f rows of one 4-column
    run do not fit shared memory (gw above about 400 at stride2 1).
    """
    if f1.device.type != "cuda" or f2.device != f1.device or grad.device != f1.device:
        raise ValueError(f"correlation_backward_cuda needs CUDA tensors on one device, got "
                         f"{f1.device} / {f2.device} / {grad.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two equal (N, H, W, C) inputs, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype or grad.dtype != f1.dtype:
        raise TypeError(f"correlation_backward_cuda: dtypes {f1.dtype} / {f2.dtype} / {grad.dtype}; "
                        "need all float32 or all bfloat16")
    if not (f1.is_contiguous() and f2.is_contiguous() and grad.is_contiguous()):
        raise ValueError("correlation_backward_cuda: inputs must be contiguous")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"bad max_displacement={max_displacement} / stride2={stride2}")
    n, h, w, c = f1.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"correlation_backward_cuda: N={n} and H={h} must each be <= 65535 (grid limits)")
    gw = 2 * (max_displacement // stride2) + 1
    if tuple(grad.shape) != (n, gw * gw, h, w):
        raise ValueError(f"grad shape {tuple(grad.shape)}, expected {(n, gw * gw, h, w)}")
    if gw * h * w >= 2**31:
        raise ValueError(f"correlation_backward_cuda takes gw*H*W < 2**31; got gw={gw}, H={h}, W={w}")
    if f1.dtype == torch.bfloat16 and c % 2:
        raise ValueError(f"correlation_backward_cuda: bfloat16 needs an even channel count, got C={c}")
    df1 = torch.empty_like(f1) if need_f1 else None
    df2 = torch.empty_like(f2) if need_f2 else None
    if not (need_f1 or need_f2) or f1.numel() == 0:
        return df1, df2
    lib = _build.library()
    status = lib.fn2_correlation_backward(
        f1.data_ptr(), f2.data_ptr(), grad.data_ptr(),
        df1.data_ptr() if need_f1 else None, df2.data_ptr() if need_f2 else None,
        n, h, w, c, max_displacement, stride2, _build.DTYPE_CODES[f1.dtype],
        torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _build.check_status(status, "correlation_backward")
    correlation_backward_cuda.launches += 1
    return df1, df2


correlation_backward_cuda.launches = 0  # kernel launches since the last reset


# -- 1-D (stereo) correlation ---------------------------------------------------


def _corr1d_geometry(max_displacement: int, stride2: int, single_direction: int) -> tuple[int, int]:
    """(gw, x_shift): the channel count and the displacement of channel 0 in
    units of stride2 (flownet2_tpu/ops/correlation.py::_corr1d_geometry)."""
    gr = max_displacement // stride2
    if single_direction != 0:
        return gr + 1, (-gr if single_direction < 0 else 0)
    return 2 * gr + 1, -gr


def correlation_1d_output_shape(
    height: int, width: int, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0, single_direction: int = 0,
) -> tuple[int, int, int]:
    """(out_h, out_w, out_channels) per correlation_layer1d.cpp: the width
    is padded, the height is not."""
    kr = (kernel_size - 1) // 2
    out_h = math.ceil((height - 2 * kr) / stride1)
    out_w = math.ceil((width + 2 * pad - 2 * (max_displacement + kr)) / stride1)
    return out_h, out_w, _corr1d_geometry(max_displacement, stride2, single_direction)[0]


def correlation_1d(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0, single_direction: int = 0, multiply: bool = True,
) -> torch.Tensor:
    """Horizontal cost volume of f1 vs f2, both (N, C, H, W) -> (N, gw, out_h, out_w)."""
    kernel = multiply and kernel_size == 1 and stride1 == 1 and pad == max_displacement
    if f1.device.type == "cuda" and kernel:
        return _Correlation1dCuda.apply(f1, f2, max_displacement, stride2, single_direction)
    if f1.device == f2.device and f1.device.type in ("cuda", "cpu"):
        return correlation_1d_plain(
            f1, f2, max_displacement=max_displacement, kernel_size=kernel_size, stride1=stride1,
            stride2=stride2, pad=pad, single_direction=single_direction, multiply=multiply,
        )
    raise ValueError(f"correlation_1d: unsupported devices {f1.device} / {f2.device}")


class _Correlation1dCuda(torch.autograd.Function):
    """The 1-D CUDA kernels under autograd. Both read and write the nets'
    NCHW layout, so f1 and f2 are saved as they are, with no layout copy."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2, single_direction):
        # the nets pass contiguous maps; anything else is made contiguous once
        f1, f2 = f1.contiguous(), f2.contiguous()
        ctx.save_for_backward(f1, f2)
        ctx.corr = dict(max_displacement=max_displacement, stride2=stride2, single_direction=single_direction)
        return correlation_1d_cuda(f1, f2, **ctx.corr)

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        need_f1, need_f2 = ctx.needs_input_grad[:2]
        df1, df2 = correlation_1d_backward_cuda(
            f1, f2, grad.to(f1.dtype).contiguous(), **ctx.corr, need_f1=need_f1, need_f2=need_f2,
        )
        return df1, df2, None, None, None


def correlation_1d_plain(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, kernel_size: int = 1,
    stride1: int = 1, stride2: int = 1, pad: int = 0, single_direction: int = 0, multiply: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version (flownet2_tpu/ops/correlation.py::correlation_1d):
    a loop over the displacements of width-padded, shifted slices with a
    channel mean, in float32; the window's origin is row y * stride1 and
    padded column md + x * stride1."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd (correlation_layer1d.cpp)")
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"need two equal (N, C, H, W) inputs, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    n, c, h, w = f1.shape
    md = max_displacement
    out_h, out_w, gw = correlation_1d_output_shape(
        h, w, max_displacement=md, kernel_size=kernel_size, stride1=stride1, stride2=stride2, pad=pad,
        single_direction=single_direction,
    )
    if out_h < 1 or out_w < 1:
        raise ValueError("correlation window does not fit in input")
    _, x_shift = _corr1d_geometry(md, stride2, single_direction)
    f1p = F.pad(f1.float(), (pad, pad))
    f2p = F.pad(f2.float(), (pad, pad))
    span_h = (out_h - 1) * stride1 + kernel_size
    span_w = (out_w - 1) * stride1 + kernel_size
    a = f1p[:, :, :span_h, md:md + span_w]
    box = torch.ones(1, 1, kernel_size, kernel_size, dtype=torch.float32, device=f1.device)
    outs = []
    for d in range(gw):
        x0 = md + (d + x_shift) * stride2
        b = f2p[:, :, :span_h, x0:x0 + span_w]
        q = (a * b).sum(dim=1) if multiply else (a - b).abs().sum(dim=1)
        if kernel_size > 1:
            q = F.conv2d(q[:, None], box)[:, 0]
        outs.append(q[:, ::stride1, ::stride1])
    out = torch.stack(outs, dim=1) / (kernel_size * kernel_size * c)
    return out.to(f1.dtype)


def correlation_1d_backward_plain(
    f1: torch.Tensor, f2: torch.Tensor, grad: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP: autograd through :func:`correlation_1d_plain` with
    the same keyword arguments. f1, f2 (N, C, H, W), grad the cotangent of
    the output; returns (df1, df2) (N, C, H, W) in the inputs' dtype."""
    with torch.enable_grad():
        a = f1.detach().requires_grad_(True)
        b = f2.detach().requires_grad_(True)
        out = correlation_1d_plain(a, b, **kwargs)
        df1, df2 = torch.autograd.grad(out, (a, b), grad.to(out.dtype))
    return df1, df2


def _check_corr1d_inputs(name: str, f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                         stride2: int) -> tuple[int, int, int, int]:
    """The checks both 1-D wrappers make on f1 and f2 (N, C, H, W); returns the shape."""
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got {f1.device} / {f2.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two equal (N, C, H, W) inputs, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"{name}: dtypes {f1.dtype} / {f2.dtype}; need both float32 or both bfloat16")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"bad max_displacement={max_displacement} / stride2={stride2}")
    n, c, h, w = f1.shape
    if n * h >= 2**30:
        raise ValueError(f"{name} takes N*H < 2**30 (32-bit work items); got N={n}, H={h}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous (N, C, H, W)")
    return n, c, h, w


def correlation_1d_cuda(
    f1: torch.Tensor, f2: torch.Tensor, *, max_displacement: int, stride2: int, single_direction: int
) -> torch.Tensor:
    """Launch the 1-D forward kernel (csrc/correlation1d.cu) on the current stream.

    DispNet configuration only (multiply, k=1, stride1=1, pad=max_displacement).
    Takes f1, f2 (N, C, H, W) contiguous, float32 or bfloat16, any C and
    storage offset, on one CUDA device, with N*H < 2**30; returns (N, gw,
    H, W) in their dtype. Raises on anything else, and where a column
    tile's f2 halo does not fit shared memory (a gw of thousands).
    """
    n, c, h, w = _check_corr1d_inputs("correlation_1d_cuda", f1, f2, max_displacement, stride2)
    gw, _ = _corr1d_geometry(max_displacement, stride2, single_direction)
    out = torch.empty((n, gw, h, w), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    status = lib.fn2_correlation_1d(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w, max_displacement, stride2,
        (single_direction > 0) - (single_direction < 0), _build.DTYPE_CODES[f1.dtype],
        torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _build.check_status(status, "correlation_1d")
    correlation_1d_cuda.launches += 1
    return out


correlation_1d_cuda.launches = 0  # kernel launches since the last reset


def correlation_1d_backward_cuda(
    f1: torch.Tensor, f2: torch.Tensor, grad: torch.Tensor, *, max_displacement: int, stride2: int,
    single_direction: int, need_f1: bool = True, need_f2: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Launch the 1-D backward kernel (csrc/correlation1d_bwd.cu) on the current stream.

    DispNet configuration only. Takes f1, f2 (N, C, H, W) and grad (N, gw,
    H, W), contiguous, all float32 or all bfloat16, any C and storage
    offset, on one CUDA device, with N*H < 2**30; returns (df1, df2) (N, C,
    H, W) contiguous in their dtype, None for a gradient not asked for.
    Both gradients are one launch. Raises on anything else, and where a
    column tile's g rows and f halo do not fit shared memory (a gw of
    hundreds).
    """
    n, c, h, w = _check_corr1d_inputs("correlation_1d_backward_cuda", f1, f2, max_displacement, stride2)
    if grad.device != f1.device or grad.dtype != f1.dtype:
        raise TypeError(f"correlation_1d_backward_cuda: grad {grad.dtype} on {grad.device}; "
                        f"need {f1.dtype} on {f1.device}")
    gw, _ = _corr1d_geometry(max_displacement, stride2, single_direction)
    if tuple(grad.shape) != (n, gw, h, w):
        raise ValueError(f"grad shape {tuple(grad.shape)}, expected {(n, gw, h, w)}")
    if not grad.is_contiguous():
        raise ValueError("correlation_1d_backward_cuda: grad must be contiguous")
    df1 = torch.empty_like(f1, memory_format=torch.contiguous_format) if need_f1 else None
    df2 = torch.empty_like(f2, memory_format=torch.contiguous_format) if need_f2 else None
    if not (need_f1 or need_f2) or f1.numel() == 0:
        return df1, df2
    lib = _build.library()
    status = lib.fn2_correlation_1d_backward(
        f1.data_ptr(), f2.data_ptr(), grad.data_ptr(),
        df1.data_ptr() if need_f1 else None, df2.data_ptr() if need_f2 else None,
        n, c, h, w, max_displacement, stride2, (single_direction > 0) - (single_direction < 0),
        _build.DTYPE_CODES[f1.dtype], torch.cuda.current_stream(f1.device).cuda_stream,
    )
    _build.check_status(status, "correlation_1d_backward")
    correlation_1d_backward_cuda.launches += 1
    return df1, df2


correlation_1d_backward_cuda.launches = 0  # kernel launches since the last reset
