"""Flow visualization: the standard Middlebury color wheel (the port's copy
of flownet2_tpu/tools/flow_vis.py, numpy only).

The reference ecosystem visualizes .flo files with the Middlebury color
coding (hue = direction, saturation = magnitude); this is the numpy
equivalent, used by tools and notebooks.
"""

from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 visualization. NaN → black."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)

    rad = np.sqrt(u * u + v * v)
    if max_flow is None:
        max_flow = max(rad.max(), 1e-9)
    u = u / max_flow
    v = v / max_flow
    rad = np.minimum(np.sqrt(u * u + v * v), 1.0)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # desaturate toward white at low magnitude
        img[..., c] = np.where(bad, 0, np.floor(255.0 * col)).astype(np.uint8)
    return img
