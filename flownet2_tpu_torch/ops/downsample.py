"""NaN-aware area downsample (the reference's ``Downsample`` layer).

Counterpart of flownet2_tpu/ops/downsample.py (reference
downsample_layer.cu:15-72):

- align-corners mapping: source centre = dest / (out-1) * (in-1);
- triangle weights max(0, 1 - |b - c| / s) per axis with s = (in-1)/(out-1),
  window radius ceil(s);
- NaN samples vote with their weight instead of adding to the value sum;
  an output is NaN when the NaN share of its weight exceeds 0.5 (cu:63-67),
  or when every sample of its window is NaN;
- identity size passes the input through (downsample_layer.cpp:53-56);
- not differentiable: it runs on ground truth only.

The weights are separable, so each of the three weighted sums (values,
valid weight, NaN weight) is two matmuls with numpy-built weight matrices,
in float32, as the JAX version's einsums.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=256)
def _axis_weights_down(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) unnormalized triangle weights, align-corners."""
    if out_size == 1:
        # the reference divides by out-1; centre the single output instead
        scale = float(in_size)
        centers = np.array([(in_size - 1) / 2.0])
    else:
        scale = (in_size - 1) / (out_size - 1)
        centers = np.arange(out_size, dtype=np.float64) * scale
    radius = int(np.ceil(scale))
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i, c in enumerate(centers):
        ic = int(np.floor(c + 0.5))  # C round() for non-negative centres
        for off in range(-radius, radius + 1):
            j = ic + off
            if 0 <= j < in_size:
                w[i, j] = max(0.0, 1.0 - abs(j - c) / scale)
    return w.astype(np.float32)


@lru_cache(maxsize=256)
def _axis_weights_down_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_axis_weights_down` on ``device``, copied there once: a copy
    per call would be a blocking copy, which waits for every step queued
    before it. A normal tensor even when the first call runs under
    inference_mode (the cache outlives that call)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_axis_weights_down(in_size, out_size)).to(device)


@torch.no_grad()
def downsample_nan_aware(x: torch.Tensor, out_height: int, out_width: int) -> torch.Tensor:
    """Downsample (..., H, W) -> (..., out_height, out_width), e.g. NCHW flow."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_height, out_width):
        return x
    w_h = _axis_weights_down_on(in_h, out_height, x.device)  # (oh, h)
    w_w = _axis_weights_down_on(in_w, out_width, x.device)  # (ow, w)

    def bilinear(z):
        return torch.matmul(torch.matmul(w_h, z), w_w.T)

    xf = x.float()
    nan_mask = torch.isnan(xf)
    valid = (~nan_mask).float()
    accum_value = bilinear(torch.where(nan_mask, 0.0, xf))
    accum_weight = bilinear(valid)
    accum_nan = bilinear(nan_mask.float())

    safe_weight = torch.where(accum_weight == 0, 1.0, accum_weight)
    out = accum_value / safe_weight
    is_nan_out = (accum_nan / safe_weight > 0.5) | ((accum_weight == 0) & (accum_nan > 0))
    return torch.where(is_nan_out, float("nan"), out).to(x.dtype)
