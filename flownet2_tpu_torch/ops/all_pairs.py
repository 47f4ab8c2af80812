"""RAFT's all-pairs cost volume and its pyramid lookup, in plain PyTorch.

:class:`AllPairs` builds the volume once a forward: the dot product of every
feature vector of frame 1 with every one of frame 2, over ``sqrt(C)``, as
one batched ``matmul``, viewed as ``N * H * W`` one-channel maps of (H, W),
then ``levels - 1`` 2x2 average pools of it (floor sizes). It is float32
whatever the features' dtype, as RAFT's mixed-precision mode keeps it.

:meth:`AllPairs.lookup` samples, at each level ``l``, a (2r+1)^2 window of
bilinear taps around ``coords / 2**l``, in pixel units with align-corners
semantics, taps outside the level reading 0 (``grid_sample``). Channel
``(2r+1)^2 * l + (2r+1) * i + j`` samples at ``(x + i - r, y + j - r)``: the
outer window index moves x, the order of RAFT's ``meshgrid(dy, dx)``, so
that its published weights fit. The grid is the published code's arithmetic
to the bit, ``2 * (coords / 2**l + offset) / (size - 1) - 1``, in three
launches a level: the powers of two fold into one scaled add (exact), and
the offsets and sizes are made once a forward on the device (no
host-to-device copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class AllPairs:
    """f1, f2: (N, C, H, W) features of the two frames."""

    def __init__(self, f1: torch.Tensor, f2: torch.Tensor, levels: int = 4, radius: int = 4):
        n, c, h, w = f1.shape
        a = f1.float().reshape(n, c, h * w)
        b = f2.float().reshape(n, c, h * w)
        corr = torch.matmul(a.transpose(1, 2), b) / (c ** 0.5)
        self.pyramid = [corr.reshape(n * h * w, 1, h, w)]
        for _ in range(levels - 1):
            self.pyramid.append(F.avg_pool2d(self.pyramid[-1], 2, stride=2))
        self.radius = radius
        k = 2 * radius + 1
        d = torch.arange(-radius, radius + 1, device=f1.device, dtype=torch.float32)
        di, dj = torch.meshgrid(d, d, indexing="ij")
        # [i, j] = 2 (i - r, j - r), the window's (dx, dy) offsets doubled
        self.offsets2 = 2 * torch.stack([di, dj], dim=-1).view(1, k, k, 2)
        self.sizes = []  # each level's (width - 1, height - 1)
        for lvl, corr in enumerate(self.pyramid):
            hl, wl = corr.shape[-2:]
            if min(hl, wl) < 2:
                raise ValueError(f"feature maps of {h}x{w} leave level {lvl} of the volume {hl}x{wl}; "
                                 f"it needs 2x2 at least ({2 ** (levels - 1)}x that at level 0)")
            size = torch.empty(2, device=f1.device)
            size[0], size[1] = wl - 1, hl - 1
            self.sizes.append(size)

    def lookup(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: (N, 2, H, W) float32 pixel positions (x, y) at level 0 ->
        (N, levels * (2r+1)^2, H, W) float32 samples of the pyramid."""
        n, _, h, w = coords.shape
        k2 = (2 * self.radius + 1) ** 2
        centre = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
        out = []
        for lvl, (corr, size) in enumerate(zip(self.pyramid, self.sizes)):
            # 2 (c / 2**l + o) == c 2**(1 - l) + 2 o exactly: scaling by a power of two rounds nothing
            grid = torch.add(self.offsets2, centre, alpha=2.0 ** (1 - lvl)).div_(size).sub_(1)
            taps = F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
            out.append(taps.view(n, h, w, k2))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()
