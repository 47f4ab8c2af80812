"""Accum: resize-and-concatenate (the reference's ``Accum`` layer) on NCHW.

Counterpart of flownet2_tpu/ops/accum.py (reference accum_layer.cpp:20-82):
every input is resized to a common target resolution and the results are
concatenated on the channel axis. The target is (a) the largest height and
width over the inputs, (b) a ``reference`` input's size, or (c) the largest
rounded up to a multiple of ``size_divisible_by``. Used to gather
multi-scale features for fusion-style nets; no net of the repository uses
it.
"""

from __future__ import annotations

from math import ceil
from typing import Optional, Sequence

import torch

from flownet2_tpu_torch.ops.resample import resample


def accum(
    inputs: Sequence[torch.Tensor],
    *,
    reference: Optional[int] = None,
    size_divisible_by: int = 0,
    method: str = "nearest",
) -> torch.Tensor:
    """Concatenate (N, c_i, h_i, w_i) inputs at a common resolution.

    ``method``: the resize of the inputs not at the target size, "nearest"
    (the reference's gather, the default) or "linear" (``ops/resample.py``,
    antialiased when downscaling).
    """
    if not inputs:
        raise ValueError("accum requires at least one input")
    if reference is not None:
        th, tw = inputs[reference].shape[2:4]
    else:
        th = max(x.shape[2] for x in inputs)
        tw = max(x.shape[3] for x in inputs)
        if size_divisible_by > 0:
            d = size_divisible_by
            th = int(ceil(th / d) * d)
            tw = int(ceil(tw / d) * d)
    return torch.cat([resample(x, th, tw, method=method) for x in inputs], dim=1)
