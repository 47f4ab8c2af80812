"""A plain-PyTorch RAFT for the test suite (Teed and Deng, ECCV 2020,
arXiv:2003.12039; the published code's test mode with its "sintel"
padding), float32 NCHW, on flat weights: convolutions ``<layer>/w`` (kh, kw,
cin, cout) and ``<layer>/b``, batch norms ``<norm>/scale``, ``/offset``,
``/mean``, ``/var``. Also the oracles of the lookup and of the convex
upsampling as loops. Imports nothing of the port and no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
RADIUS, LEVELS = 4, 4


def seeded_weights(shapes: dict, seed: int) -> dict:
    """Weights of the given shapes (``checkpoint.expected_params("raft")``'s
    keys): MSRA-normal convolutions, biases N(0, 0.01); batch norms far from
    a fresh net's (scale and variance U(0.5, 1.5), offset and mean N(0,
    0.1)), so that a skipped or misapplied norm shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "w":
            std = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
            out[key] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif leaf in ("scale", "var"):
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[key] = (rng.standard_normal(shape) * (0.01 if leaf == "b" else 0.1)).astype(np.float32)
    return out


def _w(p, key):
    return torch.as_tensor(p[f"{key}/w"]).float().permute(3, 2, 0, 1).contiguous(), torch.as_tensor(p[f"{key}/b"])


def conv(p, key, x, stride=1):
    w, b = _w(p, key)
    return F.conv2d(x, w, b, stride=stride, padding=(w.shape[2] // 2, w.shape[3] // 2))


def norm(p, key, x):
    if f"{key}/scale" in p:  # nn.BatchNorm2d in eval mode
        s, o, m, v = (torch.as_tensor(p[f"{key}/{leaf}"]) for leaf in ("scale", "offset", "mean", "var"))
        return F.batch_norm(x, m, v, s, o, training=False, eps=EPS)
    return F.instance_norm(x, eps=EPS)  # nn.InstanceNorm2d: no affine, per-sample statistics


def encoder(p, pre, x):
    x = torch.relu(norm(p, f"{pre}/norm1", conv(p, f"{pre}/conv1", x, 2)))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for i in range(2):
            blk, s = f"{pre}/{layer}/{i}", stride if i == 0 else 1
            y = torch.relu(norm(p, f"{blk}/norm1", conv(p, f"{blk}/conv1", x, s)))
            y = torch.relu(norm(p, f"{blk}/norm2", conv(p, f"{blk}/conv2", y)))
            if s != 1:
                x = norm(p, f"{blk}/downsample/1", conv(p, f"{blk}/downsample/0", x, s))
            x = torch.relu(x + y)
    return conv(p, f"{pre}/conv2", x)


def pyramid(f1, f2):
    n, c, h, w = f1.shape
    corr = torch.matmul(f1.reshape(n, c, h * w).transpose(1, 2), f2.reshape(n, c, h * w))
    levels = [corr.view(n * h * w, 1, h, w) / torch.sqrt(torch.tensor(c).float())]
    for _ in range(LEVELS - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, stride=2))
    return levels


def lookup(levels, coords):
    """As the published ``CorrBlock``: offsets stack(meshgrid(dy, dx)) added to (x, y)."""
    r = RADIUS
    coords = coords.permute(0, 2, 3, 1)
    n, h, w, _ = coords.shape
    d = torch.linspace(-r, r, 2 * r + 1)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).view(1, 2 * r + 1, 2 * r + 1, 2)
    out = []
    for i, corr in enumerate(levels):
        hl, wl = corr.shape[-2:]
        xy = coords.reshape(n * h * w, 1, 1, 2) / 2 ** i + delta
        gx, gy = xy.split([1, 1], dim=-1)
        grid = torch.cat([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1], dim=-1)
        out.append(F.grid_sample(corr, grid, align_corners=True).view(n, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def update(p, h, inp, corr, flow):
    ub = "update_block"
    cor = torch.relu(conv(p, f"{ub}/encoder/convc2", torch.relu(conv(p, f"{ub}/encoder/convc1", corr))))
    flo = torch.relu(conv(p, f"{ub}/encoder/convf2", torch.relu(conv(p, f"{ub}/encoder/convf1", flow))))
    motion = torch.cat([torch.relu(conv(p, f"{ub}/encoder/conv", torch.cat([cor, flo], dim=1))), flow], dim=1)
    x = torch.cat([inp, motion], dim=1)
    for axis in "12":
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(p, f"{ub}/gru/convz{axis}", hx))
        r = torch.sigmoid(conv(p, f"{ub}/gru/convr{axis}", hx))
        q = torch.tanh(conv(p, f"{ub}/gru/convq{axis}", torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    return h, conv(p, f"{ub}/flow_head/conv2", torch.relu(conv(p, f"{ub}/flow_head/conv1", h)))


def upsample(flow, mask):
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    return torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def raft(p, img0, img1, iters):
    """(N, H, W, 3) frames, 0-255 -> (N, H, W, 2) flow in pixels."""
    n, h, w, _ = img0.shape
    ph, pw = ((h // 8 + 1) * 8 - h) % 8, ((w // 8 + 1) * 8 - w) % 8
    pad = [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]
    x0, x1 = (2 * (F.pad(torch.as_tensor(x).float().permute(0, 3, 1, 2).contiguous(), pad, mode="replicate")
                   / 255.0) - 1.0 for x in (img0, img1))
    f1, f2 = encoder(p, "fnet", torch.cat([x0, x1])).split(n)
    c = encoder(p, "cnet", x0)
    hid, inp = torch.tanh(c[:, :128]), torch.relu(c[:, 128:])
    levels = pyramid(f1, f2)
    ys, xs = torch.meshgrid(torch.arange(f1.shape[2]), torch.arange(f1.shape[3]), indexing="ij")
    coords0 = torch.stack([xs, ys]).float()[None].repeat(n, 1, 1, 1)
    coords1 = coords0.clone()
    for _ in range(iters):
        hid, delta = update(p, hid, inp, lookup(levels, coords1), coords1 - coords0)
        coords1 = coords1 + delta
    mask = 0.25 * conv(p, "update_block/mask/2", torch.relu(conv(p, "update_block/mask/0", hid)))
    flow = upsample(coords1 - coords0, mask)
    return flow[:, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w].permute(0, 2, 3, 1)


def lookup_loop(levels, coords) -> np.ndarray:
    """The lookup by hand: for each pixel, level l and window (i, j), the
    bilinear value of level l at (x / 2**l + i - r, y / 2**l + j - r), taps
    outside the level 0; channel 81 l + 9 i + j. float64."""
    n, _, h, w = coords.shape
    k = 2 * RADIUS + 1
    out = np.zeros((n, LEVELS * k * k, h, w))
    for lvl, corr in enumerate(levels):
        maps = corr.double().numpy().reshape(n, h, w, *corr.shape[-2:])
        hl, wl = maps.shape[-2:]
        for b in range(n):
            for y in range(h):
                for x in range(w):
                    cx, cy = (float(v) / 2 ** lvl for v in coords[b, :, y, x])
                    for i in range(k):
                        for j in range(k):
                            px, py = cx + i - RADIUS, cy + j - RADIUS
                            x0, y0 = int(np.floor(px)), int(np.floor(py))
                            val = 0.0
                            for yy, wy in ((y0, 1 - (py - y0)), (y0 + 1, py - y0)):
                                for xx, wx in ((x0, 1 - (px - x0)), (x0 + 1, px - x0)):
                                    if 0 <= yy < hl and 0 <= xx < wl:
                                        val += wy * wx * maps[b, y, x, yy, xx]
                            out[b, lvl * k * k + i * k + j, y, x] = val
    return out


def upsample_loop(flow, mask) -> np.ndarray:
    """Convex upsampling by hand: output pixel (8y + a, 8x + b) is the
    softmax over the 9 mask logits (t, a, b) of 8 x the flow at the coarse
    neighbour t of (y, x), 3x3 in row order, zero outside. float64."""
    n, _, h, w = flow.shape
    f = flow.double().numpy()
    m = mask.double().numpy().reshape(n, 9, 8, 8, h, w)
    out = np.zeros((n, 2, 8 * h, 8 * w))
    for b in range(n):
        for y in range(h):
            for x in range(w):
                for a in range(8):
                    for c in range(8):
                        logits = m[b, :, a, c, y, x]
                        wts = np.exp(logits - logits.max())
                        wts /= wts.sum()
                        for t in range(9):
                            yy, xx = y + t // 3 - 1, x + t % 3 - 1
                            if 0 <= yy < h and 0 <= xx < w:
                                out[b, :, 8 * y + a, 8 * x + c] += wts[t] * 8 * f[b, :, yy, xx]
    return out
