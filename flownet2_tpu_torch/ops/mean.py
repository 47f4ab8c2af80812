"""Mean layer: add or subtract a mean with input, output and mean scales
(flownet2_tpu/ops/mean.py; reference mean_layer.cpp:33-70, MeanParameter
caffe.proto:679-691), on NCHW tensors.

Modes: per-channel values (``mean_values``) or a full mean blob
(``mean_array``); operation ADD or SUBTRACT;
out = (in * input_scale +- mean * mean_scale) * output_scale.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def apply_mean(
    x: torch.Tensor,
    *,
    mean_values: Optional[Sequence[float]] = None,
    mean_array: Optional[torch.Tensor] = None,
    operation: str = "subtract",
    input_scale: float = 1.0,
    mean_scale: float = 1.0,
    output_scale: float = 1.0,
) -> torch.Tensor:
    """x: (N, C, H, W). Exactly one of ``mean_values`` (C values) or
    ``mean_array`` ((C, H, W) or anything that broadcasts to x) is given."""
    if (mean_values is None) == (mean_array is None):
        raise ValueError("provide exactly one of mean_values or mean_array")
    if mean_values is not None:
        mean = torch.as_tensor(list(mean_values), dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    else:
        mean = mean_array.to(x.dtype)
    out = x * input_scale
    if operation == "subtract":
        out = out - mean * mean_scale
    elif operation == "add":
        out = out + mean * mean_scale
    else:
        raise ValueError(f"unknown mean operation {operation!r}")
    return out * output_scale
