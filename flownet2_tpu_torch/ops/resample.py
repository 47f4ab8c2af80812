"""Linear (triangle) and nearest resize with the reference's swapped half-pixel offsets.

Counterpart of the linear and nearest paths of flownet2_tpu/ops/resample.py
(reference resample_layer.cu). The source coordinate of an output pixel is

    x_in = x_out * fx + fy/2 - 0.5,    y_in = y_out * fy + fx/2 - 0.5

(fy in the x formula and fx in the y formula, an upstream quirk), so
``F.interpolate`` does not match. The op is separable: per axis a dense
weight matrix is built in numpy, and the resize is two matmuls,
``out = W_h @ x @ W_w^T``, in float32. Nearest picks the source pixel
round(x_in) (C round, half away from zero), clamped inside the input: a
gather of whole rows and columns, which keeps the dtype and the values.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _triangle_coeff(x: np.ndarray) -> np.ndarray:
    """Reference resample_layer.cu:28-33."""
    out = np.zeros_like(x)
    m1 = (x >= -1) & (x < 0)
    m2 = (x >= 0) & (x <= 1)
    out[m1] = x[m1] + 1
    out[m2] = 1 - x[m2]
    return out


def _c_round(x: np.ndarray) -> np.ndarray:
    """C round(): half away from zero (np.round is half-to-even)."""
    return np.trunc(x + np.copysign(0.5, x))


@lru_cache(maxsize=256)
def _axis_weights(in_size: int, out_size: int, f: float, f_other: float, antialias: bool) -> np.ndarray:
    """Dense (out_size, in_size) float32 linear weight matrix for one axis."""
    x_in = np.arange(out_size, dtype=np.float64) * f + f_other / 2.0 - 0.5
    a = 1.0 / f if (antialias and f > 1.0) else 1.0
    r = 2 if f < 1.0 else int(np.ceil(2 / a))  # kernel width 2

    x_round = _c_round(x_in).astype(np.int64)
    offsets = np.arange(-r, r + 1)
    sample_idx = x_round[:, None] + offsets[None, :]  # (out, 2r+1)
    weights = a * _triangle_coeff(a * (x_in[:, None] - sample_idx))
    weights = np.where((sample_idx >= 0) & (sample_idx < in_size), weights, 0.0)

    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), offsets.size)
    np.add.at(w, (rows, np.clip(sample_idx, 0, in_size - 1).ravel()), weights.ravel())
    # normalise each output by its weight sum, empty windows give 0 (cu:93);
    # the 2-D sum factorises per axis, so per-axis normalisation is exact
    wsum = w.sum(axis=1, keepdims=True)
    w = np.where(wsum != 0, w / np.where(wsum == 0, 1.0, wsum), 0.0)
    return w.astype(np.float32)


@lru_cache(maxsize=256)
def _axis_weights_on(
    in_size: int, out_size: int, f: float, f_other: float, antialias: bool, device: torch.device
) -> torch.Tensor:
    # a normal tensor even when the first call runs under inference_mode:
    # the cache outlives that call, and autograd refuses inference tensors
    with torch.inference_mode(False):
        return torch.from_numpy(_axis_weights(in_size, out_size, f, f_other, antialias)).to(device)


@lru_cache(maxsize=256)
def nearest_indices(in_size: int, out_size: int, f: float, f_other: float) -> np.ndarray:
    """(out_size,) int64 source index of each output pixel on one axis: the
    nearest sample round(x_in), clamped in bounds (the reference would read
    past the last pixel; the JAX package clamps too)."""
    x_in = np.arange(out_size, dtype=np.float64) * f + f_other / 2.0 - 0.5
    return np.clip(_c_round(x_in).astype(np.int64), 0, in_size - 1)


def resample(
    x: torch.Tensor, out_height: int, out_width: int, *, antialias: bool = True, method: str = "linear"
) -> torch.Tensor:
    """Resize (..., H, W) to (..., out_height, out_width).

    ``method`` "linear" computes in float32 and returns the input dtype;
    ``antialias`` widens its kernel when downscaling (resample_layer.cu:
    179-180). "nearest" gathers the source pixels at ``nearest_indices``.
    """
    if method not in ("linear", "nearest"):
        raise ValueError(f"unsupported resample method {method!r}")
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_height, out_width):
        return x
    fx = in_w / out_width
    fy = in_h / out_height
    if method == "nearest":
        rows = torch.from_numpy(nearest_indices(in_h, out_height, fy, fx)).to(x.device)
        cols = torch.from_numpy(nearest_indices(in_w, out_width, fx, fy)).to(x.device)
        return x.index_select(-2, rows).index_select(-1, cols)
    w_h = _axis_weights_on(in_h, out_height, fy, fx, antialias, x.device)
    w_w = _axis_weights_on(in_w, out_width, fx, fy, antialias, x.device)
    out = torch.matmul(w_h, x.float())
    out = torch.matmul(out, w_w.T)
    return out.to(x.dtype)
