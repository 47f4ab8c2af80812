"""Procedural optical-flow dataset generator: the offline stand-in for
FlyingChairs (the port's copy of flownet2_tpu/tools/synth_dataset.py, numpy
only; from one seed its arrays equal the JAX module's).

Recipe modeled on the FlyingChairs construction (README.md:15-22 paper:
textured backgrounds + independently moving foreground layers under affine
motion): each sample is

- a multi-octave textured background (natural-image-ish 1/f spectrum),
- K foreground rectangles with their own textures,
- a global affine background motion + per-layer affine motions,
- ``img0(x) = bilinear(img1, x + flow(x))`` — exactly the backward-warp
  consistency FlowNet's supervision assumes, so EPE against this ground
  truth is noise-free.

Written as `.flowrec` (the packed transport format, data/records.py) in
train/held-out splits.

Usage:
  python -m flownet2_tpu_torch.tools.synth_dataset --n 2048 --n-eval 64 \\
      --out /tmp/synth  # writes /tmp/synth_train.flowrec + _eval.flowrec
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Multi-octave random texture in [0, 255], (h, w, 3) float32."""
    img = np.zeros((h, w, 3), np.float32)
    for octave, amp in ((64, 0.45), (16, 0.3), (4, 0.15)):
        gh, gw = h // octave + 2, w // octave + 2
        grid = rng.uniform(0, 1, (gh, gw, 3)).astype(np.float32)
        # bilinear upsample of the coarse grid (smooth octave)
        ys = np.linspace(0, gh - 1.001, h, dtype=np.float32)
        xs = np.linspace(0, gw - 1.001, w, dtype=np.float32)
        y0 = ys.astype(np.int32)
        x0 = xs.astype(np.int32)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        # separable lerp: rows first (h, gw, 3), then columns (h, w, 3)
        rows = grid[y0] * (1 - fy) + grid[y0 + 1] * fy
        g = rows[:, x0] * (1 - fx) + rows[:, x0 + 1] * fx
        img += amp * g
    img += 0.1 * rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return np.clip(img / 1.0, 0, 1) * 255.0


def _affine_flow(
    rng: np.random.Generator, h: int, w: int, max_shift: float
) -> np.ndarray:
    """Dense flow of a random affine motion about a random center.

    Rotation/zoom ranges scale with ``max_shift`` (18 = the FlyingChairs-ish
    default) so small-shift splits are uniformly easy, not just centered.
    """
    gain = min(max_shift / 18.0, 1.0)
    angle = rng.uniform(-0.15, 0.15) * gain
    scale = np.exp(rng.uniform(-0.12, 0.12) * gain)
    tx, ty = rng.uniform(-max_shift, max_shift, 2)
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    ca, sa = np.cos(angle) * scale, np.sin(angle) * scale
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xr, yr = xs - cx, ys - cy
    u = (ca * xr - sa * yr) + cx + tx - xs
    v = (sa * xr + ca * yr) + cy + ty - ys
    return np.stack([u, v], axis=-1).astype(np.float32)


def _bilinear_warp(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """img0(x) = bilinear(img, x + flow(x)); out-of-range → 0 (the
    FlowWarp fill contract, flow_warp_layer.cpp:72)."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x2 = xs + flow[..., 0]
    y2 = ys + flow[..., 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    x2c = np.clip(x2, 0, w - 1)
    y2c = np.clip(y2, 0, h - 1)
    x0 = np.minimum(x2c.astype(np.int32), w - 2)
    y0 = np.minimum(y2c.astype(np.int32), h - 2)
    fx = np.clip(x2c - x0, 0, 1)[..., None]
    fy = np.clip(y2c - y0, 0, 1)[..., None]
    out = (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx)
        + img[y0 + 1, x0 + 1] * fy * fx
    )
    return np.where(valid[..., None], out, 0.0).astype(np.float32)


def make_sample(
    rng: np.random.Generator,
    h: int = 384,
    w: int = 512,
    n_layers: int = 3,
    max_shift: float = 18.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One (img0, img1, flow) triple, uint8/uint8/float32."""
    img1 = _texture(rng, h, w)
    flow = _affine_flow(rng, h, w, max_shift)
    for _ in range(n_layers):
        lh = int(rng.integers(h // 8, h // 2))
        lw = int(rng.integers(w // 8, w // 2))
        y0 = int(rng.integers(0, h - lh))
        x0 = int(rng.integers(0, w - lw))
        patch_tex = _texture(rng, lh, lw)
        img1[y0 : y0 + lh, x0 : x0 + lw] = patch_tex
        lflow = _affine_flow(rng, h, w, max_shift * 1.5)
        flow[y0 : y0 + lh, x0 : x0 + lw] = lflow[y0 : y0 + lh, x0 : x0 + lw]
    img0 = _bilinear_warp(img1, flow)
    return (
        np.clip(img0, 0, 255).astype(np.uint8),
        np.clip(img1, 0, 255).astype(np.uint8),
        flow,
    )


def write_split(
    path: str,
    n: int,
    seed: int,
    h: int,
    w: int,
    log=print,
    *,
    max_shift: float = 18.0,
    n_layers: int = 3,
) -> None:
    from flownet2_tpu_torch.data.records import FlowRecordWriter

    rng = np.random.default_rng(seed)
    with FlowRecordWriter(path) as wtr:
        for i in range(n):
            img0, img1, flow = make_sample(
                rng, h, w, n_layers=n_layers, max_shift=max_shift
            )
            wtr.write(img0, img1, flow)
            if (i + 1) % 256 == 0:
                log(f"{path}: {i + 1}/{n}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=2048, help="training samples")
    p.add_argument("--n-eval", type=int, default=64, help="held-out samples")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="prefix: writes <out>_train.flowrec + <out>_eval.flowrec")
    args = p.parse_args(argv)
    write_split(
        args.out + "_train.flowrec", args.n, args.seed, args.height, args.width
    )
    write_split(
        args.out + "_eval.flowrec",
        args.n_eval,
        args.seed + 999_983,  # disjoint stream
        args.height,
        args.width,
    )
    print(f"wrote {args.n} train + {args.n_eval} eval samples under {args.out}_*")
    return 0


if __name__ == "__main__":
    sys.exit(main())
