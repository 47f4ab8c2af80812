"""The plain reference of RAFT (Teed and Deng, "RAFT: Recurrent All-Pairs
Field Transforms for Optical Flow", ECCV 2020, arXiv:2003.12039), the full
model of its public code (princeton-vl/RAFT: ``core/raft.py``,
``extractor.py``, ``update.py``, ``corr.py``, ``utils/utils.py``) as its
Sintel evaluation runs it (``evaluate.py``: "sintel" padding to /8, 32
updates, test mode), in plain PyTorch and float32.

Weights are a dict of host arrays under ``/``-joined keys: convolutions
``<layer>/w`` (kh, kw, cin, cout) and ``<layer>/b``, batch norms
``<norm>/scale``, ``/offset``, ``/mean``, ``/var`` (the layout the benchmark
draws them in, :func:`make_weights`). :class:`Ops` holds the products (the
convolutions and the volume's ``matmul``); :class:`FlopCounter` tallies
their operations by phase. Departures from the published code: the mask
head and the upsampling run once, after the last update (the published code
runs them at every update and returns the last in test mode: the same
output), and the dropout the encoders take when training is absent.

Imports nothing of the measured program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HIDDEN, CONTEXT, FEATURES = 128, 128, 256
LEVELS, RADIUS = 4, 4
EPS = 1e-5
BIAS_STD = 0.01
NORM_OFFSET_STD, NORM_MEAN_STD = 0.1, 0.1
NORM_SCALE_RANGE, NORM_VAR_RANGE = (0.5, 1.5), (0.5, 1.5)

# -- architecture: convolutions (key, cin, cout, (kh, kw)); batch norms (key, channels)


def _encoder(pre: str, cout: int, batch_norm: bool) -> tuple[list, list]:
    convs, norms = [(f"{pre}/conv1", 3, 64, (7, 7))], [(f"{pre}/norm1", 64)]
    cin = 64
    for layer, planes, stride in (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 2)):
        for i in range(2):
            blk, s = f"{pre}/{layer}/{i}", stride if i == 0 else 1
            convs += [(f"{blk}/conv1", cin, planes, (3, 3)), (f"{blk}/conv2", planes, planes, (3, 3))]
            norms += [(f"{blk}/norm1", planes), (f"{blk}/norm2", planes)]
            if s != 1:
                convs.append((f"{blk}/downsample/0", cin, planes, (1, 1)))
                norms.append((f"{blk}/downsample/1", planes))
            cin = planes
    convs.append((f"{pre}/conv2", 128, cout, (1, 1)))
    return convs, (norms if batch_norm else [])


def layers() -> tuple[list, list]:
    """Every convolution and batch norm of the model."""
    fc, _ = _encoder("fnet", FEATURES, False)
    cc, cn = _encoder("cnet", HIDDEN + CONTEXT, True)
    ub = "update_block"
    update = [(f"{ub}/encoder/convc1", LEVELS * (2 * RADIUS + 1) ** 2, 256, (1, 1)),
              (f"{ub}/encoder/convc2", 256, 192, (3, 3)), (f"{ub}/encoder/convf1", 2, 128, (7, 7)),
              (f"{ub}/encoder/convf2", 128, 64, (3, 3)), (f"{ub}/encoder/conv", 256, 126, (3, 3))]
    for axis, k in (("1", (1, 5)), ("2", (5, 1))):
        update += [(f"{ub}/gru/conv{g}{axis}", HIDDEN + CONTEXT + 128, HIDDEN, k) for g in "zrq"]
    update += [(f"{ub}/flow_head/conv1", HIDDEN, 256, (3, 3)), (f"{ub}/flow_head/conv2", 256, 2, (3, 3)),
               (f"{ub}/mask/0", HIDDEN, 256, (3, 3)), (f"{ub}/mask/2", 256, 576, (1, 1))]
    return fc + cc + update, cn


def param_shapes() -> dict:
    convs, norms = layers()
    out = {}
    for key, cin, cout, (kh, kw) in convs:
        out[f"{key}/w"], out[f"{key}/b"] = (kh, kw, cin, cout), (cout,)
    for key, c in norms:
        out.update({f"{key}/{leaf}": (c,) for leaf in ("scale", "offset", "mean", "var")})
    return out


def make_weights(seed: int, device) -> dict[str, np.ndarray]:
    """Seeded weights, drawn on the device in two calls: MSRA normal
    convolutions, N(0, 2 / (kh kw cin)), biases N(0, 0.01), batch-norm
    offsets and means N(0, 0.1); scales and variances U(0.5, 1.5). Far from a
    fresh net's norms, so that a norm skipped or misapplied shows."""
    convs, norms = layers()
    normal, uniform = [], []  # (key, shape, std or (lo, hi))
    for key, cin, cout, (kh, kw) in convs:
        normal += [(f"{key}/w", (kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5), (f"{key}/b", (cout,), BIAS_STD)]
    for key, c in norms:
        normal += [(f"{key}/offset", (c,), NORM_OFFSET_STD), (f"{key}/mean", (c,), NORM_MEAN_STD)]
        uniform += [(f"{key}/scale", (c,), NORM_SCALE_RANGE), (f"{key}/var", (c,), NORM_VAR_RANGE)]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for parts, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [int(np.prod(shape)) for _, shape, _ in parts]
        block = draw(sum(sizes), generator=gen, device=device)
        a = torch.tensor([p[2] if draw is torch.randn else p[2][1] - p[2][0] for p in parts], device=device)
        b = torch.tensor([0.0 if draw is torch.randn else p[2][0] for p in parts], device=device)
        counts = torch.tensor(sizes, device=device)
        block = block * torch.repeat_interleave(a, counts) + torch.repeat_interleave(b, counts)
        host, off = block.cpu().numpy(), 0
        for (key, shape, _), size in zip(parts, sizes):
            out[key] = host[off:off + size].reshape(shape)
            off += size
    return out


def prepare(params: dict, device=None) -> dict:
    """The weights as the reference uses them: conv ``key`` -> (OIHW weight,
    bias); batch norm ``key`` -> (scale, offset, mean, var); float32."""
    convs, norms = layers()

    def t(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    out = {key: (t(params[f"{key}/w"]).permute(3, 2, 0, 1).contiguous(), t(params[f"{key}/b"]))
           for key, *_ in convs}
    out.update({key: tuple(t(params[f"{key}/{leaf}"]) for leaf in ("scale", "offset", "mean", "var"))
                for key, _ in norms})
    return out


# -- the products


class Ops:
    """The reference's products: a convolution (padding (kh // 2, kw // 2))
    and the all-pairs ``matmul``. ``phase`` names the part of the model
    running (set by :func:`raft`)."""

    phase = ""

    def conv(self, x, w, b, stride=1):
        return F.conv2d(x, w, b, stride=stride, padding=(w.shape[2] // 2, w.shape[3] // 2))

    def matmul(self, a, b):
        return torch.matmul(a, b)


class FlopCounter(Ops):
    """:class:`Ops` that counts the operations of each product (a
    multiply-add is two) under the phase running: ``encode``, ``volume``,
    ``update`` (all updates) and ``mask``."""

    def __init__(self):
        self.flops = {}

    def _add(self, f):
        self.flops[self.phase] = self.flops.get(self.phase, 0) + f

    def conv(self, x, w, b, stride=1):
        out = super().conv(x, w, b, stride)
        self._add(2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return out

    def matmul(self, a, b):
        out = super().matmul(a, b)
        self._add(2 * out.numel() * a.shape[-1])
        return out


# -- the plain layers


def _norm(P, key, x):
    """The published ``nn.BatchNorm2d`` in eval mode where ``P`` holds the norm,
    else its ``nn.InstanceNorm2d`` (no affine, per-sample statistics)."""
    if key in P:
        scale, offset, mean, var = P[key]
        return F.batch_norm(x, mean, var, scale, offset, training=False, eps=EPS)
    return F.instance_norm(x, eps=EPS)


def _conv(ops, P, key, x, stride=1):
    w, b = P[key]
    return ops.conv(x, w, b, stride)


def encoder(ops, P, pre, x):
    """BasicEncoder: instance norm where ``P`` holds no norm of ``pre``, batch norm where it does."""
    x = torch.relu(_norm(P, f"{pre}/norm1", _conv(ops, P, f"{pre}/conv1", x, 2)))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for i in range(2):
            blk, s = f"{pre}/{layer}/{i}", stride if i == 0 else 1
            y = torch.relu(_norm(P, f"{blk}/norm1", _conv(ops, P, f"{blk}/conv1", x, s)))
            y = torch.relu(_norm(P, f"{blk}/norm2", _conv(ops, P, f"{blk}/conv2", y)))
            if s != 1:
                x = _norm(P, f"{blk}/downsample/1", _conv(ops, P, f"{blk}/downsample/0", x, s))
            x = torch.relu(x + y)
    return _conv(ops, P, f"{pre}/conv2", x)


def corr_pyramid(ops, f1, f2):
    """The published ``CorrBlock``: (N*H*W, 1, H, W) dot products over sqrt(C), then 3 avg pools."""
    n, c, h, w = f1.shape
    corr = ops.matmul(f1.reshape(n, c, h * w).transpose(1, 2), f2.reshape(n, c, h * w))
    corr = corr.view(n * h * w, 1, h, w) / torch.sqrt(torch.tensor(c).float())
    pyramid = [corr]
    for _ in range(LEVELS - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


def bilinear_sampler(img, coords):
    """The published sampler: pixel coordinates (x, y) in, align-corners ``grid_sample``, zeros outside."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * xgrid / (w - 1) - 1, 2 * ygrid / (h - 1) - 1], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def lookup(pyramid, coords):
    """The published ``CorrBlock.__call__``: delta = stack(meshgrid(dy, dx)), added to (x, y)."""
    r = RADIUS
    coords = coords.permute(0, 2, 3, 1)
    n, h, w, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
        centroid = coords.reshape(n * h * w, 1, 1, 2) / 2 ** i
        out.append(bilinear_sampler(corr, centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2)).view(n, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def update(ops, P, h, inp, corr, flow):
    """BasicUpdateBlock without its mask head: motion encoder, SepConvGRU, flow head."""
    ub = "update_block"
    cor = torch.relu(_conv(ops, P, f"{ub}/encoder/convc1", corr))
    cor = torch.relu(_conv(ops, P, f"{ub}/encoder/convc2", cor))
    flo = torch.relu(_conv(ops, P, f"{ub}/encoder/convf1", flow))
    flo = torch.relu(_conv(ops, P, f"{ub}/encoder/convf2", flo))
    motion = torch.cat([torch.relu(_conv(ops, P, f"{ub}/encoder/conv", torch.cat([cor, flo], dim=1))), flow], dim=1)
    x = torch.cat([inp, motion], dim=1)
    for axis in "12":
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(ops, P, f"{ub}/gru/convz{axis}", hx))
        r = torch.sigmoid(_conv(ops, P, f"{ub}/gru/convr{axis}", hx))
        q = torch.tanh(_conv(ops, P, f"{ub}/gru/convq{axis}", torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    delta = _conv(ops, P, f"{ub}/flow_head/conv2", torch.relu(_conv(ops, P, f"{ub}/flow_head/conv1", h)))
    return h, delta


def upsample_flow(flow, mask):
    """The published convex upsampling: (N, 2, H, W), (N, 576, H, W) -> (N, 2, 8H, 8W)."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def encode(ops, P, img0, img1):
    """The encoders and the volume on 0-255 NCHW frames whose sides are
    multiples of 8: (pyramid, initial state h, context, coords0)."""
    n = img0.shape[0]
    x0, x1 = 2 * (img0 / 255.0) - 1.0, 2 * (img1 / 255.0) - 1.0
    ops.phase = "encode"
    f1, f2 = encoder(ops, P, "fnet", torch.cat([x0, x1], dim=0)).split(n)  # both frames as one batch
    c = encoder(ops, P, "cnet", x0)
    h, inp = torch.tanh(c[:, :HIDDEN]), torch.relu(c[:, HIDDEN:])
    ops.phase = "volume"
    pyramid = corr_pyramid(ops, f1, f2)
    hh, ww = f1.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(hh, device=f1.device), torch.arange(ww, device=f1.device), indexing="ij")
    coords0 = torch.stack([xs, ys]).float()[None].repeat(n, 1, 1, 1)
    return pyramid, h, inp, coords0


def mask_upsample(ops, P, h, flow):
    """The mask head on the last state and the convex upsampling of the 1/8 flow."""
    ops.phase = "mask"
    mask = 0.25 * _conv(ops, P, "update_block/mask/2", torch.relu(_conv(ops, P, "update_block/mask/0", h)))
    return upsample_flow(flow, mask)


def raft(ops, P, img0, img1, iters: int, lookup_fn=lookup):
    """RAFT in test mode on 0-255 NCHW frames whose sides are multiples of 8 -> (N, 2, H, W) flow."""
    pyramid, h, inp, coords0 = encode(ops, P, img0, img1)
    ops.phase = "update"
    coords1 = coords0.clone()
    for _ in range(iters):
        corr = lookup_fn(pyramid, coords1)
        h, delta = update(ops, P, h, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
    return mask_upsample(ops, P, h, coords1 - coords0)


def pad_to_8(h: int, w: int) -> tuple[int, int, int, int]:
    """The published ``InputPadder`` in "sintel" mode: (top, bottom, left, right)."""
    ph, pw = (((h // 8) + 1) * 8 - h) % 8, (((w // 8) + 1) * 8 - w) % 8
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def pad_frames(img0, img1):
    """(N, H, W, 3) frames -> both replicate-padded to /8, float32 NCHW, and the pads."""
    pads = pad_to_8(img0.shape[1], img0.shape[2])
    top, bottom, left, right = pads
    x0, x1 = (F.pad(x.float().permute(0, 3, 1, 2).contiguous(), [left, right, top, bottom], mode="replicate")
              for x in (img0, img1))
    return x0, x1, pads


def crop(flow, pads, h: int, w: int):
    """(N, 2, H', W') flow of the padded frame -> (N, h, w, 2)."""
    top, _, left, _ = pads
    return flow[:, :, top:top + h, left:left + w].permute(0, 2, 3, 1)


def run_raft(ops, P, img0, img1, iters: int):
    """The Sintel evaluation on (N, H, W, 3) frames: replicate-pad to /8, RAFT,
    crop -> (N, H, W, 2) float32 flow in pixels."""
    x0, x1, pads = pad_frames(img0, img1)
    return crop(raft(ops, P, x0, x1, iters), pads, img0.shape[1], img0.shape[2])


def forward_flops(h: int, w: int, iters: int) -> dict:
    """A pair's product operations at the padded size (h, w), by phase
    (``encode``: the three encoder passes; ``volume``; ``update``: all
    ``iters``; ``mask``), counted on the meta device (shapes only). Every
    update has the same shapes: one is counted and multiplied."""
    P = prepare({k: torch.empty(s, device="meta") for k, s in param_shapes().items()}, "meta")
    counter = FlopCounter()
    x = torch.empty(1, 3, h, w, device="meta")
    with torch.no_grad():
        raft(counter, P, x, x, 1, lookup_fn=_meta_lookup)
    return dict(counter.flops, update=counter.flops["update"] * iters)


def _meta_lookup(pyramid, coords):
    """The lookup's output shape alone (no product to count)."""
    n, _, h, w = coords.shape
    return torch.empty(n, LEVELS * (2 * RADIUS + 1) ** 2, h, w, device=coords.device)
