"""Seeded weights, drawn on the device in a few large calls.

MSRA normal draws, N(0, 2 / (k k cin)), for every conv and deconv weight,
in the layout the port's ``checkpoint.load_into`` and ``FlowRunner`` take
(conv (kh, kw, cin, cout), deconv (kh, kw, cout, cin)), and small normal
biases (std ``BIAS_STD``) so that the comparison sees the biases too. One
``randn`` fills every weight and bias; one multiply scales each to its
layer's std; one copy brings the block to the host, where the port's
loader takes its arrays. The benchmark hands the same block to the port
and to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nets import layer_table

BIAS_STD = 0.01


def make_weights(model: str, seed: int, device) -> dict[str, np.ndarray]:
    """``net/layer/w`` and ``/b`` -> float32 host arrays (views of one block)."""
    shapes, stds = [], []
    for key, kind, cin, cout, k, _ in layer_table(model):
        shapes.append((f"{key}/w", (k, k, cout, cin) if kind == "deconv" else (k, k, cin, cout)))
        stds.append((2.0 / (k * k * cin)) ** 0.5)
        shapes.append((f"{key}/b", (cout,)))
        stds.append(BIAS_STD)
    sizes = [int(np.prod(s)) for _, s in shapes]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    block = torch.randn(sum(sizes), generator=gen, device=device)
    block.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), torch.tensor(sizes, device=device)))
    host = block.cpu().numpy()
    out, off = {}, 0
    for (key, shape), size in zip(shapes, sizes):
        out[key] = host[off:off + size].reshape(shape)
        off += size
    return out
