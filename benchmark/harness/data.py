"""Input frames and ground truth, made on the device from the seed.

A pair is a textured frame, a smooth random flow field and the second
frame sampled from the first along it: three octaves of uniform noise
upsampled bilinearly (coarse blobs, mid texture, fine grain), the flow a
bilinear upsample of gaussian noise at 1/64 resolution with a standard
deviation of ``FLOW_STD`` pixels, rounded to 1/32 of a pixel (the packed
records' fixed point, so that packing loses nothing). Everything is drawn
by one ``torch.Generator`` on the device, in a few batched calls, and comes
to the host as uint8 frames and float32 flow, (N, H, W, C).

Also the two files of FlyingChairs' public layout: binary PPM frames and
Middlebury ``.flo`` flow.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FLOW_STD = 6.0
OCTAVES = ((32, 0.5), (8, 0.3), (2, 0.2))  # (downscale, weight)


def make_pairs(n: int, h: int, w: int, seed: int, device) -> dict[str, np.ndarray]:
    """{"img0", "img1": (n, h, w, 3) uint8, "flow": (n, h, w, 2) float32}."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.zeros(n, 3, h, w, device=device)
    for down, weight in OCTAVES:
        coarse = torch.rand(n, 3, -(-h // down) + 1, -(-w // down) + 1, generator=gen, device=device)
        img += weight * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    img = img * 255.0
    coarse = torch.randn(n, 2, -(-h // 64) + 1, -(-w // 64) + 1, generator=gen, device=device) * FLOW_STD
    flow = torch.round(F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) * 32.0) / 32.0
    # frame 1 at x + flow(x) shows what frame 0 shows at x: sample frame 0 at x - flow(x)
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    gx = (xs - flow[:, 0]) / (w - 1) * 2 - 1
    gy = (ys - flow[:, 1]) / (h - 1) * 2 - 1
    img1 = F.grid_sample(img, torch.stack([gx, gy], dim=-1), mode="bilinear", padding_mode="border",
                         align_corners=True)

    def u8(x):
        return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()

    return {"img0": u8(img), "img1": u8(img1), "flow": flow.permute(0, 2, 3, 1).contiguous().cpu().numpy()}


def write_ppm(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 as binary PPM (P6)."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def write_flo(path: str, flow: np.ndarray) -> None:
    """(H, W, 2) float32 as Middlebury .flo: b"PIEH", int32 width, height, then the values row-major."""
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(b"PIEH")
        f.write(np.asarray([w, h], "<i4").tobytes())
        f.write(np.ascontiguousarray(flow, "<f4").tobytes())
