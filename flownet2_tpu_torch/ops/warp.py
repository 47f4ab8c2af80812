"""FlowWarp: backward-warp an image by a flow with bilinear sampling.

Counterpart of flownet2_tpu/ops/warp.py (``flow_warp_gather``, the exact
path) and of the TPU kernels flownet2_tpu/ops/pallas/warp.py::
flow_warp_pallas (forward) and ::flow_warp_pallas_bwd (its VJP).
Conventions, as in the reference flow_warp_layer.cpp:

- sample position x2 = x + u, y2 = y + v, in float32;
- valid iff 0 <= x2 < W and 0 <= y2 < H, else ``fill_value`` (0 or NaN);
- the 2x2 footprint's base is min(floor(clip(x2, 0, W-1)), W-2) (rows the
  same), with the fractional weight clipped to [0, 1]: this reproduces the
  reference's clamp of the right/bottom neighbour to the last column/row.

Layout: image (N, C, H, W), flow (N, 2, H, W) with (u, v) in channels 0
and 1, output (N, C, H, W). A CUDA tensor goes to an autograd Function
whose forward is the hand-written kernel (csrc/warp.cu) and whose backward
is the kernel's VJP (csrc/warp_bwd.cu); a CPU tensor goes to
:func:`flow_warp_plain`, which autograd differentiates.
"""

from __future__ import annotations

import torch

from flownet2_tpu_torch import _build


def flow_warp(image: torch.Tensor, flow: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Warp ``image`` (N,C,H,W) by ``flow`` (N,2,H,W) -> (N,C,H,W)."""
    if image.device.type == "cuda":
        return _FlowWarpCuda.apply(image, flow, fill_value)
    if image.device.type == "cpu" and flow.device.type == "cpu":
        return flow_warp_plain(image, flow, fill_value)
    raise ValueError(f"flow_warp: unsupported devices {image.device} / {flow.device}")


class _FlowWarpCuda(torch.autograd.Function):
    """The CUDA kernels under autograd: forward ``flow_warp_cuda``, backward
    ``flow_warp_backward_cuda`` for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, image, flow, fill_value):
        image, flow = image.contiguous(), flow.contiguous()
        ctx.save_for_backward(image, flow)
        return flow_warp_cuda(image, flow, fill_value)

    @staticmethod
    def backward(ctx, grad):
        image, flow = ctx.saved_tensors
        need_image, need_flow, _ = ctx.needs_input_grad
        d_image, d_flow = flow_warp_backward_cuda(
            image, flow, grad.to(image.dtype).contiguous(), need_image=need_image, need_flow=need_flow
        )
        return d_image, d_flow, None


def _check_shapes(image: torch.Tensor, flow: torch.Tensor) -> None:
    if image.dim() != 4:
        raise ValueError(f"image must be (N, C, H, W), got {tuple(image.shape)}")
    n, _, h, w = image.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"flow shape {tuple(flow.shape)} incompatible with image {tuple(image.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"flow_warp needs H, W >= 2, got {h}x{w}")


def flow_warp_plain(image: torch.Tensor, flow: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: float32 4-tap gather by advanced indexing."""
    _check_shapes(image, flow)
    n, c, h, w = image.shape
    img = image.float()
    fl = flow.float()
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=image.device),
        torch.arange(w, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    x2 = xs + fl[:, 0]  # (N, H, W)
    y2 = ys + fl[:, 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    # NaN or infinite coordinates are invalid; zero them so the index math
    # below stays in range (their output is the fill value)
    x2s = torch.where(valid, x2, 0.0).clamp(0.0, w - 1)
    y2s = torch.where(valid, y2, 0.0).clamp(0.0, h - 1)
    xb = torch.floor(x2s).long().clamp(max=w - 2)
    yb = torch.floor(y2s).long().clamp(max=h - 2)
    alpha = (x2s - xb.float()).clamp(0.0, 1.0)[:, None]  # (N, 1, H, W)
    beta = (y2s - yb.float()).clamp(0.0, 1.0)[:, None]

    flat = img.reshape(n, c, h * w)

    def tap(rows, cols):
        idx = (rows * w + cols).reshape(n, 1, h * w).expand(n, c, h * w)
        return torch.gather(flat, 2, idx).reshape(n, c, h, w)

    top = tap(yb, xb) * (1 - alpha) + tap(yb, xb + 1) * alpha
    bot = tap(yb + 1, xb) * (1 - alpha) + tap(yb + 1, xb + 1) * alpha
    out = top * (1 - beta) + bot * beta
    out = torch.where(valid[:, None], out, torch.tensor(fill_value, dtype=torch.float32, device=out.device))
    return out.to(image.dtype)


def flow_warp_cuda(image: torch.Tensor, flow: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/warp.cu) on the current stream.

    Takes contiguous CUDA tensors on one device: image (N,C,H,W) float32 or
    bfloat16, flow (N,2,H,W) float32 or bfloat16. Raises on anything else.
    """
    _check_shapes(image, flow)
    if image.device.type != "cuda" or flow.device != image.device:
        raise ValueError(f"flow_warp_cuda needs CUDA tensors on one device, got {image.device} / {flow.device}")
    for name, t in (("image", image), ("flow", flow)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flow_warp_cuda: {name} dtype {t.dtype} is not float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flow_warp_cuda: {name} must be contiguous")
    n, c, h, w = image.shape
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    lib = _build.library()
    status = lib.fn2_flow_warp(
        image.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
        _build.DTYPE_CODES[image.dtype], _build.DTYPE_CODES[flow.dtype], float(fill_value),
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check_status(status, "flow_warp")
    flow_warp_cuda.launches += 1
    return out


flow_warp_cuda.launches = 0  # kernel launches since the last reset


def flow_warp_backward_plain(
    image: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP: autograd through :func:`flow_warp_plain`.
    Returns (d_image, d_flow) in the dtypes of image and flow. The fill
    value does not enter: invalid pixels pass no gradient either way."""
    with torch.enable_grad():
        img = image.detach().requires_grad_(True)
        fl = flow.detach().requires_grad_(True)
        out = flow_warp_plain(img, fl)
        d_image, d_flow = torch.autograd.grad(out, (img, fl), grad.to(out.dtype))
    return d_image, d_flow


def flow_warp_backward_cuda(
    image: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor, *,
    need_image: bool = True, need_flow: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Launch the backward kernel (csrc/warp_bwd.cu) on the current stream.

    Takes contiguous CUDA tensors on one device: image (N,C,H,W) and grad
    (the cotangent of the output, same shape and dtype), flow (N,2,H,W);
    float32 or bfloat16. Returns (d_image, d_flow) in the dtypes of image
    and flow, with None for a gradient not asked for. Raises on anything
    else.
    """
    _check_shapes(image, flow)
    for name, t in (("image", image), ("flow", flow), ("grad", grad)):
        if t.device != image.device or t.device.type != "cuda":
            raise ValueError(f"flow_warp_backward_cuda needs CUDA tensors on one device, got {name} on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flow_warp_backward_cuda: {name} dtype {t.dtype} is not float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flow_warp_backward_cuda: {name} must be contiguous")
    if grad.shape != image.shape or grad.dtype != image.dtype:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} does not match image "
                         f"{tuple(image.shape)} {image.dtype}")
    n, c, h, w = image.shape
    # the kernel scatters d_image with float32 atomics
    d_image = torch.zeros(image.shape, dtype=torch.float32, device=image.device) if need_image else None
    d_flow = torch.empty_like(flow) if need_flow else None
    if not (need_image or need_flow) or image.numel() == 0:
        return d_image, d_flow
    lib = _build.library()
    status = lib.fn2_flow_warp_backward(
        image.data_ptr(), flow.data_ptr(), grad.data_ptr(),
        d_image.data_ptr() if need_image else None, d_flow.data_ptr() if need_flow else None,
        n, c, h, w, _build.DTYPE_CODES[image.dtype], _build.DTYPE_CODES[flow.dtype],
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check_status(status, "flow_warp_backward")
    flow_warp_backward_cuda.launches += 1
    if need_image:
        d_image = d_image.to(image.dtype)
    return d_image, d_flow


flow_warp_backward_cuda.launches = 0  # kernel launches since the last reset
