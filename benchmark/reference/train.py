"""The plain reference of FlowNetC's training step, as the paper's first
stage trains it (FlowNet 2.0, section 4 and lmb-freiburg/flownet2's training
templates): the batch the keyed loader makes, the augmentation, the
multi-scale EPE loss, the backward and Adam.

Everything the program's loader and sampler draw is worked out again here
from the seed by frozen copies of their rules: the epochs' sample order,
each batch's augmentation coefficients (the FlowNet2 templates'
distributions, with the reference's rejection of crops that leave the
source), and the noise fields, drawn by a generator on the device seeded
as the program seeds its own. The device transforms are written from the
Caffe layers (DataAugmentation, FlowAugmentation): an affine bilinear crop
with clamped positions, the paired ground-truth flow transform by the
nearest source pixel, the chromatic transform and gaussian noise.

Imports nothing of the measured program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nets

SCALE_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.02, 3: 0.01, 2: 0.005}
L1_EPSILON = 1e-2
MAX_TRIES = 50

# (rand_type, exp, mean, spread) of each coefficient (FlowNet2 training templates)
SPATIAL = dict(translate=("uniform", False, 0.0, 0.4), rotate=("uniform", False, 0.0, 0.4),
               zoom=("uniform", True, 0.2, 0.4), squeeze=("uniform", True, 0.0, 0.3))
SPATIAL_OFFSET = dict(translate=("gaussian", False, 0.0, 0.03), rotate=("gaussian", False, 0.0, 0.03),
                      zoom=("gaussian", True, 0.0, 0.03))
CHROMATIC = dict(gamma=("gaussian", True, 0.0, 0.02), brightness=("gaussian", False, 0.0, 0.02),
                 contrast=("gaussian", True, 0.0, 0.02), color=("gaussian", True, 0.0, 0.02))
NOISE = ("uniform", False, 0.03, 0.03)


# -- the loader's order and the sampler's draws


def batch_indices(n_samples: int, batch: int, k: int, seed: int) -> list[int]:
    """Samples of batch k: positions [k b, (k + 1) b) of the epochs' seeded
    permutations laid end to end (epoch e permuted by a generator seeded seed + e)."""
    out, orders = [], {}
    for pos in range(k * batch, (k + 1) * batch):
        e = pos // n_samples
        if e not in orders:
            orders[e] = np.random.default_rng(seed + e).permutation(n_samples)
        out.append(int(orders[e][pos % n_samples]))
    return out


def _draw(spec, rng, n):
    """n draws of a coefficient that is always on: the on/off draw, then the value."""
    kind, exp, mean, spread = spec
    rng.uniform(size=n)  # the Bernoulli gate (probability 1)
    v = rng.uniform(mean - spread, mean + spread, n) if kind == "uniform" else rng.normal(mean, spread, n)
    return np.exp(v) if exp else v


def _compose(m, u):
    t0, t1, t2, t3, t4, t5 = m
    u0, u1, u2, u3, u4, u5 = u
    return (t0 * u0 + t1 * u2, t0 * u1 + t1 * u3, t2 * u0 + t3 * u2, t2 * u1 + t3 * u3,
            t4 * u0 + t5 * u2 + u4, t4 * u1 + t5 * u3 + u5)


def crop_to_source(dx, dy, angle, zx, zy, crop_w, crop_h, src_w, src_h) -> np.ndarray:
    """The crop -> source affine (x' = t0 x + t2 y + t4, y' = t1 x + t3 y + t5):
    centre, rotate, translate, unzoom, uncentre."""
    m = (1.0, 0.0, 0.0, 1.0, -0.5 * crop_w, -0.5 * crop_h)
    if angle:
        m = _compose(m, (math.cos(angle), math.sin(angle), -math.sin(angle), math.cos(angle), 0, 0))
    if dx or dy:
        m = _compose(m, (1, 0, 0, 1, dx * crop_w, dy * crop_h))
    if zx != 1.0 or zy != 1.0:
        m = _compose(m, (1.0 / zx, 0, 0, 1.0 / zy, 0, 0))
    return np.asarray(_compose(m, (1, 0, 0, 1, 0.5 * src_w, 0.5 * src_h)), np.float32)


def _corners_inside(dx, dy, angle, zx, zy, crop_w, crop_h, src_w, src_h):
    ok = np.ones(np.shape(angle), bool)
    for cx in (0, crop_w - 1):
        for cy in (0, crop_h - 1):
            x1, y1 = cx - 0.5 * crop_w, cy - 0.5 * crop_h
            x2 = (np.cos(angle) * x1 - np.sin(angle) * y1 + dx * crop_w) / zx + 0.5 * src_w
            y2 = (np.sin(angle) * x1 + np.cos(angle) * y1 + dy * crop_h) / zy + 0.5 * src_h
            ok &= (np.floor(x2) >= 0) & (np.floor(x2) <= src_w - 2) & (np.floor(y2) >= 0) & (np.floor(y2) <= src_h - 2)
    return ok


def _spatial(specs, rng, n, geo, base=None):
    """(n, 5) [dx, dy, angle, zoom_x, zoom_y]: the first of MAX_TRIES candidates
    whose crop stays inside the source, else ``base`` (identity without one)."""
    t = n * MAX_TRIES
    dx, dy = _draw(specs["translate"], rng, t), _draw(specs["translate"], rng, t)
    angle = _draw(specs["rotate"], rng, t)
    zx = _draw(specs["zoom"], rng, t)
    zy = zx.copy()
    if "squeeze" in specs:
        sq = _draw(specs["squeeze"], rng, t)
        zx, zy = zx * sq, zy / sq
    if base is not None:
        b = np.repeat(np.asarray(base, np.float64), MAX_TRIES, axis=0)
        dx, dy, angle = dx + b[:, 0], dy + b[:, 1], angle + b[:, 2]
        zx, zy = zx * b[:, 3], zy * b[:, 4]
    ok = _corners_inside(dx, dy, angle, zx, zy, **geo).reshape(n, MAX_TRIES)
    cand = np.stack([dx, dy, angle, zx, zy], axis=1).reshape(n, MAX_TRIES, 5)
    out = cand[np.arange(n), np.argmax(ok, axis=1)]
    fallback = np.asarray(base, np.float64) if base is not None else np.tile([0, 0, 0, 1, 1], (n, 1))
    return np.where(ok.any(axis=1)[:, None], out, fallback).astype(np.float32)


def sample_coefficients(rng: np.random.Generator, n: int, src_h: int, src_w: int, crop_h: int, crop_w: int) -> dict:
    """A batch's augmentation: frame 0's crop -> source affine, frame 1's
    (frame 0's coefficients plus a small offset) and its inverse, the
    chromatic coefficients and the noise std, in the sampler's draw order."""
    geo = dict(crop_w=crop_w, crop_h=crop_h, src_w=src_w, src_h=src_h)
    c0 = _spatial(SPATIAL, rng, n, geo)
    c1 = _spatial(SPATIAL_OFFSET, rng, n, geo, base=c0)
    m0 = np.stack([crop_to_source(*(float(v) for v in c), crop_w, crop_h, src_w, src_h) for c in c0])
    m1 = np.stack([crop_to_source(*(float(v) for v in c), crop_w, crop_h, src_w, src_h) for c in c1])
    a, b, c, d, e, f = (m1[:, i] for i in range(6))
    det = a * d - b * c
    inv1 = np.stack([d / det, -b / det, -c / det, a / det, (c * f - d * e) / det, (b * e - a * f) / det],
                    axis=1).astype(np.float32)
    gamma, brightness, contrast = (_draw(CHROMATIC[k], rng, n) for k in ("gamma", "brightness", "contrast"))
    color = np.stack([_draw(CHROMATIC["color"], rng, n) for _ in range(3)], axis=1)
    noise = np.maximum(_draw(NOISE, rng, n), 0.0)
    f32 = {k: np.asarray(v, np.float32) for k, v in
           dict(gamma=gamma, brightness=brightness, contrast=contrast, color=color, noise=noise).items()}
    return dict(mat0=m0, mat1=m1, inv_mat1=inv1, **f32)


# -- the device transforms


def _grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return xs, ys


def _affine(t, xs, ys):
    c = [t[:, i, None, None] for i in range(6)]
    return c[0] * xs + c[2] * ys + c[4], c[1] * xs + c[3] * ys + c[5]


def spatial_crop(img, mat, out_h, out_w):
    """Bilinear sample of ``img`` (N, C, H, W) at mat(x, y) of each crop pixel,
    positions clamped into [0, W - 1.05] x [0, H - 1.05], over the canvas
    max(source, crop), then its top-left crop."""
    n, c, h, w = img.shape
    ch, cw = max(h, out_h), max(w, out_w)
    if (ch, cw) != (h, w):
        img = torch.nn.functional.pad(img, (0, cw - w, 0, ch - h))
    xs, ys = _grid(ch, cw, img.device)
    xp, yp = _affine(mat, xs, ys)
    flow = torch.stack([xp.clamp(0.0, w - 1.05) - xs, yp.clamp(0.0, h - 1.05) - ys], dim=1)
    return nets.flow_warp(img, flow)[:, :, :out_h, :out_w]


def flow_transform(flow, mat0, inv_mat1, out_h, out_w):
    """Ground truth seen through both crops: a crop pixel p maps to s = mat0(p)
    in the source, takes the flow f at the source pixel nearest s (rounded
    half to even), and its target in frame 1's crop is inv_mat1(s + f); the new flow is that minus p."""
    n, _, h, w = flow.shape
    xs, ys = _grid(out_h, out_w, flow.device)
    xsrc, ysrc = _affine(mat0, xs, ys)
    xi = torch.round(xsrc).long().clamp(0, w - 1)
    yi = torch.round(ysrc).long().clamp(0, h - 1)
    idx = (yi * w + xi).reshape(n, 1, -1).expand(n, 2, -1)
    f = torch.gather(flow.reshape(n, 2, h * w), 2, idx).reshape(n, 2, out_h, out_w)
    xt, yt = _affine(inv_mat1, xsrc + f[:, 0], ysrc + f[:, 1])
    return torch.stack([xt - xs, yt - ys], dim=1)


def chromatic(x, gamma, brightness, contrast, color):
    """On [0, 1]: per-channel colour, then contrast and brightness about the
    pixel's channel mean, then gamma, each clamped to [0, 1]."""
    x = torch.clamp(x * color[:, :, None, None], 0.0, 1.0)
    mean = x.mean(dim=1, keepdim=True)
    x = torch.clamp((x - mean) * contrast[:, None, None, None] + mean + brightness[:, None, None, None], 0.0, 1.0)
    return x ** gamma[:, None, None, None]


def augment(img0, img1, flow, coeffs, gen, crop_h, crop_w):
    """uint8 NHWC frames and float flow at source size -> NCHW 0-255 frames and flow at crop size."""
    t = {k: torch.from_numpy(v).to(img0.device) for k, v in coeffs.items()}
    a = spatial_crop(img0.permute(0, 3, 1, 2).float() / 255.0, t["mat0"], crop_h, crop_w)
    b = spatial_crop(img1.permute(0, 3, 1, 2).float() / 255.0, t["mat1"], crop_h, crop_w)
    f = flow_transform(flow.permute(0, 3, 1, 2).float(), t["mat0"], t["inv_mat1"], crop_h, crop_w)
    out = []
    for x in (a, b):
        x = chromatic(x, t["gamma"], t["brightness"], t["contrast"], t["color"])
        noise = torch.randn(x.shape, generator=gen, dtype=torch.float32, device=x.device)
        out.append(torch.clamp(x + noise * t["noise"][:, None, None, None], 0.0, 1.0) * 255.0)
    return out[0], out[1], f


# -- the loss and the optimizer


@torch.no_grad()
def area_downsample(x, out_h, out_w):
    """Caffe Downsample: triangle weights of radius (in - 1) / (out - 1) about
    each output's align-corners centre, normalised by the weight sum (the
    ground truth here has no invalid pixels); a single output sits at the
    centre with radius ``in``."""
    def axis(n_in, n_out):
        s = (n_in - 1) / (n_out - 1) if n_out > 1 else float(n_in)
        centres = np.arange(n_out) * s if n_out > 1 else np.array([(n_in - 1) / 2.0])
        j = np.arange(n_in)
        m = np.maximum(0.0, 1.0 - np.abs(j[None, :] - centres[:, None]) / s)
        return torch.from_numpy(m.astype(np.float32)).to(x.device)

    mh, mw = axis(x.shape[2], out_h), axis(x.shape[3], out_w)
    num = torch.matmul(torch.matmul(mh, x), mw.T)
    den = torch.matmul(torch.matmul(mh, torch.ones_like(x[:, :1])), mw.T)
    return num / den


def multiscale_epe(flows: dict, gt):
    """Sum over scales of weight x (sum over pixels of sqrt(|pred - gt/20|^2 + eps)) / batch."""
    target = gt / nets.DIV_FLOW
    total = torch.zeros((), device=gt.device)
    for lvl in (6, 5, 4, 3, 2):
        pred = flows[lvl]
        t = area_downsample(target, pred.shape[2], pred.shape[3])
        d = pred - t
        total = total + SCALE_WEIGHTS[lvl] * torch.sqrt((d * d).sum(dim=1) + L1_EPSILON).sum() / pred.shape[0]
    return total


class Adam:
    """Adam as Caffe's solver applies it: m and v with bias correction,
    step lr m_hat / (sqrt(v_hat) + delta)."""

    def __init__(self, lr: float, b1: float, b2: float, delta: float):
        self.lr, self.b1, self.b2, self.delta, self.t = lr, b1, b2, delta, 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.m[k] = (1 - self.b1) * g + self.b1 * self.m.get(k, torch.zeros_like(g))
            self.v[k] = (1 - self.b2) * g * g + self.b2 * self.v.get(k, torch.zeros_like(g))
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p -= self.lr * (m_hat / (torch.sqrt(v_hat) + self.delta))


def reference_steps(params: dict, data: dict, seed: int, traffic: dict, solver: dict, device, steps: int = 3) -> dict:
    """The first ``steps`` training steps from ``params`` on the batches the
    program's loader makes from ``data`` (host arrays, (N, H, W, C)) with
    ``seed``: {"losses": [...], "grad": {leaf: step 1's gradient}, "flow":
    step 1's finest prediction (flow2, net units), "weights": {leaf: after the
    last step}}; leaves are "layer/w" and "layer/b"."""
    model = "flownetc"
    P = {k: (w.clone().requires_grad_(), b.clone().requires_grad_())
         for k, (w, b) in nets.prepare(params, model, device).items()}
    leaves = {f"{k}/{n}": t for k, wb in P.items() for n, t in zip("wb", wb)}
    opt = Adam(solver["base_lr"], solver["momentum"], solver["momentum2"], solver["delta"])
    ops = nets.Ops()
    gen = torch.Generator(device=device).manual_seed(seed)
    sh, sw = traffic["source_height"], traffic["source_width"]
    ch, cw, b = traffic["crop_height"], traffic["crop_width"], traffic["batch"]
    losses, first_grad = [], None
    for k in range(steps):
        idx = batch_indices(len(data["img0"]), b, k, seed)
        img0, img1, flow = (torch.from_numpy(data[name][idx]).to(device) for name in ("img0", "img1", "flow"))
        if traffic["augment"]:
            coeffs = sample_coefficients(np.random.default_rng([seed, k]), b, sh, sw, ch, cw)
            with torch.no_grad():
                x0, x1, gt = augment(img0, img1, flow, coeffs, gen, ch, cw)
        else:
            y0, x0_ = (sh - ch) // 2, (sw - cw) // 2
            x0 = img0[:, y0:y0 + ch, x0_:x0_ + cw].permute(0, 3, 1, 2).float()
            x1 = img1[:, y0:y0 + ch, x0_:x0_ + cw].permute(0, 3, 1, 2).float()
            gt = flow[:, y0:y0 + ch, x0_:x0_ + cw].permute(0, 3, 1, 2).float()
        n0, n1 = nets.normalize_pair(x0, x1)
        flows = nets.flownet_c(ops, P, "", n0, n1)
        if k == 0:
            first_flow = flows[2].detach().clone()
        loss = multiscale_epe(flows, gt)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(leaves, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": first_grad, "flow": first_flow,
            "weights": {k: t.detach() for k, t in leaves.items()}}
