"""RAFT: Recurrent All-Pairs Field Transforms (Teed and Deng, ECCV 2020,
arXiv:2003.12039), the published full model: 5,257,536 parameters.

Two encoders at 1/8 resolution (``BasicEncoder``): ``fnet`` with instance
norm on both frames, ``cnet`` with batch norm (running statistics) on frame
1, whose 256 channels split into the GRU's initial state (tanh) and its
context (ReLU). The all-pairs volume of the two feature maps and its
4-level pyramid (``ops/all_pairs.py``), then ``iters`` updates: a 9x9
window at each level around the current coordinates (324 channels), the
motion encoder, a separable conv GRU and the flow head, whose output moves
the coordinates. After the last update the mask head weighs each output
pixel's 3x3 coarse neighbours (convex upsampling to full resolution). The
published code runs the mask head and the upsampling at every update and
returns the last in test mode; here they run once, with the same output.

Module names are the published ones (``fnet.layer1.0.conv1``,
``update_block.gru.convz1``, ...), so a published ``state_dict`` is a
renaming away: its ``norm3`` entries alias ``downsample.1`` and its batch
norms carry a ``num_batches_tracked`` that inference does not read.

The forward opens ``torch.profiler.record_function`` ranges:
``fn2.raft.encode`` (both encoders), ``fn2.raft.volume`` (the product and
the pyramid), ``fn2.raft.refine`` (every update and the upsampling) and,
inside it, ``fn2.raft.lookup`` once an update. ``RAFT.updates`` counts the
updates run, over every instance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from flownet2_tpu_torch.ops.all_pairs import AllPairs

HIDDEN = 128  # GRU state channels
CONTEXT = 128  # context channels
FEATURES = 256  # fnet's output channels
LEVELS = 4
RADIUS = 4
ITERS = 32  # the published Sintel evaluation's updates
EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Batch norm in inference: scale, offset, running mean and variance."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, EPS)


def _norm(kind: str, channels: int) -> nn.Module:
    return nn.InstanceNorm2d(channels, eps=EPS) if kind == "instance" else FrozenBatchNorm2d(channels)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride), _norm(norm, cout))
                           if stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/2 conv, three stages of two residual blocks (64, 96/2, 128/2), 1x1 conv."""

    def __init__(self, out_channels: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm), ResidualBlock(64, 64, norm))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2), ResidualBlock(96, 96, norm))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2), ResidualBlock(128, 128, norm))
        self.conv2 = nn.Conv2d(128, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(LEVELS * (2 * RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    """A GRU of 1x5 convs, then one of 5x1 convs, on the same input."""

    def __init__(self, hidden: int = HIDDEN, inputs: int = CONTEXT + 128):
        super().__init__()
        for axis, (k, p) in (("1", ((1, 5), (0, 2))), ("2", ((5, 1), (2, 0)))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{axis}", nn.Conv2d(hidden + inputs, hidden, k, padding=p))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for axis in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{axis}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{axis}")(hx))
            q = torch.tanh(getattr(self, f"convq{axis}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HIDDEN, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HIDDEN, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, h, inp, corr, flow) -> tuple[torch.Tensor, torch.Tensor]:
        """One update: (new state, flow increment)."""
        h = self.gru(h, torch.cat([inp, self.encoder(flow, corr)], dim=1))
        return h, self.flow_head(h)


def coords_grid(n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 2, h, w) float32 pixel grid, channel 0 x and channel 1 y."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([xs, ys]).expand(n, 2, h, w)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W) flow at 1/8 and (N, 576, H, W) mask logits -> (N, 2, 8H, 8W):
    each output pixel a softmax-weighted sum of its 3x3 coarse neighbours' 8x flow."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """``iters``: the updates a forward runs (32, the published Sintel evaluation's)."""

    updates = 0
    pads_to_8 = True  # FlowRunner's input rule: replicate-pad the frames to /8 and crop the flow (no resize)

    def __init__(self, iters: int = ITERS):
        super().__init__()
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        self.iters = iters
        self.fnet = BasicEncoder(FEATURES, "instance")
        self.cnet = BasicEncoder(HIDDEN + CONTEXT, "batch")
        self.update_block = BasicUpdateBlock()

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) RGB frames, 0-255, H and W multiples of 8 (in the
        parameters' dtype) -> (N, 2, H, W) float32 flow in pixels."""
        n = img0.shape[0]
        x0, x1 = (2 * (x / 255.0) - 1.0 for x in (img0, img1))
        with record_function("fn2.raft.encode"):
            f1, f2 = self.fnet(torch.cat([x0, x1], dim=0)).split(n)
            h, inp = self.cnet(x0).split([HIDDEN, CONTEXT], dim=1)
            h, inp = torch.tanh(h), F.relu(inp)
        with record_function("fn2.raft.volume"):
            volume = AllPairs(f1, f2, LEVELS, RADIUS)
        with record_function("fn2.raft.refine"):
            coords0 = coords_grid(n, f1.shape[2], f1.shape[3], f1.device)
            coords1 = coords0
            for _ in range(self.iters):
                with record_function("fn2.raft.lookup"):
                    corr = volume.lookup(coords1)
                flow = (coords1 - coords0).to(h.dtype)
                h, delta = self.update_block(h, inp, corr.to(h.dtype), flow)
                coords1 = coords1 + delta.float()
                RAFT.updates += 1
            mask = 0.25 * self.update_block.mask(h)
            return convex_upsample(coords1 - coords0, mask.float())
