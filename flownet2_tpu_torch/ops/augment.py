"""The augmentation engine: coefficient sampling and the device transforms.

Counterpart of flownet2_tpu/ops/augment.py (reference src/caffe/layers/
{augmentation_layer_base,data_augmentation_layer,flow_augmentation_layer,
black_augmentation_layer}.*):

- **Host side** (numpy, the JAX module's code): per-item coefficient
  sampling with the reference's distributions (util/rng.cpp:8-114) and the
  rejection loop that keeps the transformed crop inside the source
  (augmentation_layer_base.cpp:101-169, at most 50 tries). From one
  ``np.random.Generator`` it gives the JAX module's numbers.
- **Device side** (torch, NCHW, float32 on every device): the affine image
  sample as a flow warp through ``ops/warp.flow_warp`` (the hand-written
  kernel K1 on a CUDA tensor, its plain version on the CPU), the paired
  ground-truth flow transform by a nearest gather, the chromatic,
  chromatic-eigen, noise, shadow and black transforms.

The position arithmetic is the JAX code's chain of separate elementwise
float32 ops, so the CPU and the card compute the same sample positions bit
for bit and the nearest sample's rounding cannot differ between them.

Affine convention (augmentation_layer_base.cpp:14-48): 2x3 matrices
compose center -> mirror -> rotate -> translate -> zoom^-1 -> uncenter; the
matrix maps OUTPUT (crop) pixel coordinates to SOURCE pixel coordinates,
so applying it is one inverse-warp gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from flownet2_tpu_torch.ops.warp import flow_warp


# ---------------------------------------------------------------------------
# Random generator spec (RandomGeneratorParameter, caffe.proto:607-616)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RandomSpec:
    rand_type: str = "uniform"  # uniform|gaussian|bernoulli|uniform_bernoulli|gaussian_bernoulli
    exp: bool = False
    mean: float = 0.0
    spread: float = 0.0
    prob: float = 1.0
    apply_schedule: bool = True
    discretize: bool = False
    multiplier: float = 1.0

    def sample(self, rng: np.random.Generator, discount: float = 1.0, prob0_value: float = np.nan) -> float:
        """Mirror of caffe_rng_generate (util/rng.cpp:8-114)."""
        spread = self.spread * discount if self.apply_schedule else self.spread
        t = self.rand_type
        if t == "uniform":
            v = rng.uniform(self.mean - spread, self.mean + spread) if spread > 0 else self.mean
            if self.exp:
                v = math.exp(v)
        elif t == "gaussian":
            v = rng.normal(self.mean, spread) if spread > 0 else self.mean
            if self.exp:
                v = math.exp(v)
        elif t == "bernoulli":
            v = float(rng.uniform() < self.prob) if self.prob > 0 else 0.0
        elif t in ("uniform_bernoulli", "gaussian_bernoulli"):
            on = (rng.uniform() < self.prob) if self.prob > 0 else False
            if not on:
                if not math.isnan(prob0_value):
                    return prob0_value
                v = 0.0
            else:
                if spread > 0:
                    v = (
                        rng.uniform(self.mean - spread, self.mean + spread)
                        if t == "uniform_bernoulli"
                        else rng.normal(self.mean, spread)
                    )
                else:
                    v = self.mean
            if self.exp:
                v = math.exp(v)
        else:
            raise ValueError(f"unknown rand_type {t!r}")
        if self.discretize:
            v = float(round(v))
        return self.multiplier * v


@dataclass(frozen=True)
class CoeffSchedule:
    """Discount ramp (CoeffScheduleParameter caffe.proto:693-697; formula
    data_augmentation_layer.cu:370-372)."""

    half_life: float = 1.0
    initial_coeff: float = 1.0
    final_coeff: float = 1.0

    def at(self, iteration: float) -> float:
        s = 2.0 / (1.0 + math.exp(-1.0986 * iteration / self.half_life)) - 1.0
        return self.initial_coeff + (self.final_coeff - self.initial_coeff) * s


# ---------------------------------------------------------------------------
# Spatial coefficients and the affine composition
# ---------------------------------------------------------------------------


@dataclass
class SpatialCoeffs:
    mirror: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    angle: float = 0.0
    zoom_x: float = 1.0
    zoom_y: float = 1.0


@dataclass(frozen=True)
class SpatialAugSpec:
    mirror: Optional[RandomSpec] = None
    translate: Optional[RandomSpec] = None
    translate_x: Optional[RandomSpec] = None
    translate_y: Optional[RandomSpec] = None
    rotate: Optional[RandomSpec] = None
    zoom: Optional[RandomSpec] = None
    squeeze: Optional[RandomSpec] = None

    def any(self) -> bool:
        return any(
            getattr(self, f) is not None
            for f in ("mirror", "translate", "translate_x", "translate_y", "rotate", "zoom", "squeeze")
        )

    def sample(self, rng: np.random.Generator, discount: float = 1.0) -> SpatialCoeffs:
        """generate_spatial_coeffs (augmentation_layer_base.cpp:75-99)."""
        c = SpatialCoeffs()
        if self.mirror is not None:
            c.mirror = self.mirror.sample(rng, discount)
        if self.translate is not None:
            c.dx = self.translate.sample(rng, discount)
            c.dy = self.translate.sample(rng, discount)
        if self.translate_x is not None:
            c.dx = self.translate_x.sample(rng, discount)
        if self.translate_y is not None:
            c.dy = self.translate_y.sample(rng, discount)
        if self.rotate is not None:
            c.angle = self.rotate.sample(rng, discount)
        if self.zoom is not None:
            c.zoom_x = self.zoom.sample(rng, discount)
            c.zoom_y = c.zoom_x
        if self.squeeze is not None:
            s = self.squeeze.sample(rng, discount)
            c.zoom_x *= s
            c.zoom_y /= s
        return c


def _left_multiply(m, u):
    """Compose 2x3 affines the reference way (augmentation_layer_base.cpp:22-36).

    m, u: tuples (t0..t5) with x' = t0*x + t2*y + t4, y' = t1*x + t3*y + t5.
    """
    t0, t1, t2, t3, t4, t5 = m
    u0, u1, u2, u3, u4, u5 = u
    return (
        t0 * u0 + t1 * u2,
        t0 * u1 + t1 * u3,
        t2 * u0 + t3 * u2,
        t2 * u1 + t3 * u3,
        t4 * u0 + t5 * u2 + u4,
        t4 * u1 + t5 * u3 + u5,
    )


def spatial_matrix(c: SpatialCoeffs, crop_w: int, crop_h: int, src_w: int, src_h: int) -> np.ndarray:
    """Crop-pixel -> source-pixel affine (tTransMat::fromCoeff,
    augmentation_layer_base.cpp:38-48). Returns (6,) float32 [t0..t5]."""
    m = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    if c.mirror:
        m = _left_multiply(m, (-1, 0, 0, 1, 0.5 * crop_w, -0.5 * crop_h))
    else:
        m = _left_multiply(m, (1, 0, 0, 1, -0.5 * crop_w, -0.5 * crop_h))
    if c.angle:
        m = _left_multiply(m, (math.cos(c.angle), math.sin(c.angle), -math.sin(c.angle), math.cos(c.angle), 0, 0))
    if c.dx or c.dy:
        m = _left_multiply(m, (1, 0, 0, 1, c.dx * crop_w, c.dy * crop_h))
    if c.zoom_x != 1.0 or c.zoom_y != 1.0:
        m = _left_multiply(m, (1.0 / c.zoom_x, 0, 0, 1.0 / c.zoom_y, 0, 0))
    m = _left_multiply(m, (1, 0, 0, 1, 0.5 * src_w, 0.5 * src_h))
    return np.asarray(m, np.float32)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """tTransMat::inverse (augmentation_layer_base.cpp:52-69)."""
    a, b, c, d, e, f = m
    denom = a * d - b * c
    return np.asarray(
        [d / denom, -b / denom, -c / denom, a / denom, (c * f - d * e) / denom, (b * e - a * f) / denom],
        np.float32,
    )


def crop_fits(c: SpatialCoeffs, crop_w: int, crop_h: int, src_w: int, src_h: int) -> bool:
    """All 4 transformed crop corners land inside the source
    (augmentation_layer_base.cpp:131-162)."""
    for x in (0, crop_w - 1):
        for y in (0, crop_h - 1):
            if c.mirror:
                x1, y1 = -x + 0.5 * crop_w, y - 0.5 * crop_h
            else:
                x1, y1 = x - 0.5 * crop_w, y - 0.5 * crop_h
            x2 = math.cos(c.angle) * x1 - math.sin(c.angle) * y1
            y2 = math.sin(c.angle) * x1 + math.cos(c.angle) * y1
            x2 += c.dx * crop_w
            y2 += c.dy * crop_h
            x2 /= c.zoom_x
            y2 /= c.zoom_y
            x2 += 0.5 * src_w
            y2 += 0.5 * src_h
            if math.floor(x2) < 0 or math.floor(x2) > src_w - 2:
                return False
            if math.floor(y2) < 0 or math.floor(y2) > src_h - 2:
                return False
    return True


def sample_valid_spatial_coeffs(
    spec: SpatialAugSpec,
    rng: np.random.Generator,
    *,
    crop_w: int,
    crop_h: int,
    src_w: int,
    src_h: int,
    discount: float = 1.0,
    base: Optional[SpatialCoeffs] = None,
    max_tries: int = 50,
) -> SpatialCoeffs:
    """Rejection-sample coeffs whose crop stays in bounds
    (generate_valid_spatial_coeffs, augmentation_layer_base.cpp:101-169).
    ``base`` adds incoming coeffs (the img2-relative-to-img1 mode)."""
    base_arr = base or SpatialCoeffs()
    for _ in range(max_tries):
        c = spec.sample(rng, discount)
        c = SpatialCoeffs(  # additive composition in coefficient space, like coeff arrays
            mirror=float(bool(c.mirror) != bool(base_arr.mirror)),
            dx=c.dx + base_arr.dx,
            dy=c.dy + base_arr.dy,
            angle=c.angle + base_arr.angle,
            zoom_x=c.zoom_x * base_arr.zoom_x,
            zoom_y=c.zoom_y * base_arr.zoom_y,
        )
        if crop_fits(c, crop_w, crop_h, src_w, src_h):
            return c
    return base_arr


# ---------------------------------------------------------------------------
# Chromatic and effect coefficients
# ---------------------------------------------------------------------------


@dataclass
class ChromaticCoeffs:
    gamma: float = 1.0
    brightness: float = 0.0
    contrast: float = 1.0
    color: tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclass(frozen=True)
class ChromaticAugSpec:
    gamma: Optional[RandomSpec] = None
    brightness: Optional[RandomSpec] = None
    contrast: Optional[RandomSpec] = None
    color: Optional[RandomSpec] = None

    def any(self) -> bool:
        return any(getattr(self, f) is not None for f in ("gamma", "brightness", "contrast", "color"))

    def sample(self, rng: np.random.Generator, discount: float = 1.0) -> ChromaticCoeffs:
        c = ChromaticCoeffs()
        if self.gamma is not None:
            c.gamma = self.gamma.sample(rng, discount)
        if self.brightness is not None:
            c.brightness = self.brightness.sample(rng, discount)
        if self.contrast is not None:
            c.contrast = self.contrast.sample(rng, discount)
        if self.color is not None:
            c.color = tuple(self.color.sample(rng, discount) for _ in range(3))
        return c


@dataclass(frozen=True)
class EffectAugSpec:
    """Effect-family sampling specs (generate_effect_coeffs,
    augmentation_layer_base.cpp:313-336). Noise and shadow have device
    transforms (apply_gaussian_noise / apply_shadow); fog and motion blur
    are sampled into the coefficient array for blob parity but, like the
    reference kernel, which never implemented them (ApplyEffects,
    data_augmentation_layer.cu:296-318), have no image effect."""

    noise: Optional[RandomSpec] = None
    shadow_angle: Optional[RandomSpec] = None
    shadow_distance: Optional[RandomSpec] = None
    shadow_strength: Optional[RandomSpec] = None
    fog_amount: Optional[RandomSpec] = None
    fog_size: Optional[RandomSpec] = None
    motion_blur_angle: Optional[RandomSpec] = None
    motion_blur_size: Optional[RandomSpec] = None

    def sample_noise_std(self, rng: np.random.Generator, discount: float = 1.0) -> float:
        return self.noise.sample(rng, discount) if self.noise is not None else 0.0


# ---------------------------------------------------------------------------
# Device side: batched transforms on NCHW tensors, float32
# ---------------------------------------------------------------------------


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys), each (h, w) float32: the column and the row of every pixel."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xs, ys


def _affine_apply(t: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per item, (t0*x + t2*y + t4, t1*x + t3*y + t5) -> two (N, h, w) fields:
    the JAX code's chain of separate float32 ops, in its order. ``t``:
    (N, 6) float32; ``xs``, ``ys``: (h, w) or (N, h, w)."""

    def c(i):
        return t[:, i, None, None]

    return c(0) * xs + c(2) * ys + c(4), c(1) * xs + c(3) * ys + c(5)


def affine_position_flow(matrices: torch.Tensor, src_h: int, src_w: int, canvas_h: int, canvas_w: int) -> torch.Tensor:
    """The sample positions of crop -> source affines as a flow over a
    canvas: (N, 2, canvas_h, canvas_w) float32, contiguous, the positions
    (clamped into the source at [0, src_w-1.05] x [0, src_h-1.05], cu:46-47)
    minus the pixel grid (the JAX package's ``_affine_positions``)."""
    xs, ys = _pixel_grid(canvas_h, canvas_w, matrices.device)
    xpos, ypos = _affine_apply(matrices.float(), xs, ys)
    xpos = torch.clamp(xpos, 0.0, src_w - 1.05)
    ypos = torch.clamp(ypos, 0.0, src_h - 1.05)
    return torch.stack([xpos - xs, ypos - ys], dim=1)


def apply_spatial_transform(
    images: torch.Tensor,
    matrices: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    sample_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse-warp bilinear crop (SpatialAugmentation kernel,
    data_augmentation_layer.cu:25-70) as a flow warp.

    images: (N, C, H, W); matrices: (N, 6) crop -> source affines; returns
    (N, C, out_h, out_w) float32. Sample positions clamp into the source, so
    every bilinear tap lies inside it.

    The canvas is max(source, crop): ``flow_warp`` (K1 on a CUDA tensor)
    samples the image at grid + :func:`affine_position_flow`, and the
    top-left out_h x out_w of the result is the crop. Where the crop is
    larger than the source the image is zero-padded to the canvas; the
    clamped positions never read the pad. The flow's round trip
    x + (xpos - x) can move a position by one float32 ulp from the JAX
    gather's.

    ``sample_dtype``: float32 (the default) samples as the reference's Caffe
    layer and the JAX package's exact route do. ``torch.bfloat16`` is the
    JAX package's accelerator route (``_apply_spatial_transform_warp``):
    the image goes to ``flow_warp`` in bfloat16 with the float32 position
    flow (K1's bf16-image route), and the bf16 result comes back as
    float32. One difference stays: K1 and its plain version weight the
    taps in float32, while the TPU kernel rounds its horizontal weights to
    bfloat16 (up to 2^-9 of a pixel value before the output's rounding).
    """
    if sample_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sample_dtype must be float32 or bfloat16, got {sample_dtype}")
    n, c, h, w = images.shape
    ch, cw = max(h, out_h), max(w, out_w)
    img = images.float()
    if (ch, cw) != (h, w):
        img = F.pad(img, (0, cw - w, 0, ch - h))
    out = flow_warp(img.to(sample_dtype).contiguous(), affine_position_flow(matrices, h, w, ch, cw))
    return out[:, :, :out_h, :out_w].float()


def apply_chromatic_transform(
    images: torch.Tensor,
    gamma: torch.Tensor,
    brightness: torch.Tensor,
    contrast: torch.Tensor,
    color: torch.Tensor,
    *,
    max_multiplier: float = 1.0,
) -> torch.Tensor:
    """ColorContrastAugmentation (data_augmentation_layer.cu:73-117).

    Per pixel (images scaled to [0, 1]): per-channel color scaling, then
    contrast and brightness around the pixel's channel mean, then gamma.
    Per item: gamma/brightness/contrast (N,), color (N, 3).
    """
    x = images.float()
    g = gamma[:, None, None, None]
    b = brightness[:, None, None, None]
    ct = contrast[:, None, None, None]
    col = color[:, :, None, None]
    x = torch.clamp(x * col, 0.0, max_multiplier)
    mean = torch.mean(x, dim=1, keepdim=True)
    x = torch.clamp((x - mean) * ct + mean + b, 0.0, max_multiplier)
    x = torch.clamp(x, 0.0, max_multiplier) ** g
    return x.to(images.dtype)


def apply_gaussian_noise(
    images: torch.Tensor, noise_std: torch.Tensor, generator: torch.Generator, *, max_multiplier: float = 1.0
) -> torch.Tensor:
    """Additive gaussian noise (data_augmentation_layer.cu:579-586, cuRAND
    there): a standard normal draw from ``generator`` (on the images'
    device) times the item's std, then clamped to [0, max_multiplier]."""
    noise = torch.randn(images.shape, generator=generator, dtype=torch.float32, device=images.device)
    out = images.float() + noise * noise_std[:, None, None, None]
    return torch.clamp(out, 0.0, max_multiplier).to(images.dtype)


def apply_flow_augmentation(
    flows: torch.Tensor, inv_mat1: torch.Tensor, mat2: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Transform ground-truth flow consistently with both image transforms
    (flow_augmentation_layer.cu:24-89).

    For each target pixel p: s = A1(p), the source position by image 0's
    crop -> source matrix (``inv_mat1``); f = the flow at the nearest source
    pixel (cu:52-58; round half to even, as ``jnp.round``); the target in
    image 1's crop frame is A2(s + f) by image 1's source -> crop matrix
    (``mat2``); the new flow is that target minus p. flows: (N, 2, H, W)
    float32 at source resolution; returns (N, 2, out_h, out_w). NaN pixels
    (invalid ground truth) pass through the gather unchanged.
    """
    n, _, h, w = flows.shape
    xs, ys = _pixel_grid(out_h, out_w, flows.device)
    xsrc, ysrc = _affine_apply(inv_mat1.float(), xs, ys)
    xi = torch.round(xsrc).long().clamp(0, w - 1)
    yi = torch.round(ysrc).long().clamp(0, h - 1)
    idx = (yi * w + xi).reshape(n, 1, out_h * out_w).expand(n, 2, out_h * out_w)
    f = torch.gather(flows.float().reshape(n, 2, h * w), 2, idx).reshape(n, 2, out_h, out_w)
    x2 = xsrc + f[:, 0]
    y2 = ysrc + f[:, 1]
    xt2, yt2 = _affine_apply(mat2.float(), x2, y2)
    return torch.stack([xt2 - xs, yt2 - ys], dim=1)


def apply_black_augmentation(
    images: torch.Tensor, flows: torch.Tensor, black_mask: torch.Tensor, border_frac: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """BlackAugmentation (black_augmentation_layer.cu:14-60): zero whole
    image+flow pairs, or a border band of ``border_frac`` of the size.

    images (N, C, H, W), flows (N, 2, H, W); black_mask (N,) in {0, 1};
    border_frac (N,) in [0, 0.5).
    """
    n, _, h, w = images.shape
    keep = (1.0 - black_mask)[:, None, None, None]
    xs, ys = _pixel_grid(h, w, images.device)
    bw = border_frac[:, None, None] * w
    bh = border_frac[:, None, None] * h
    inside = ((xs >= bw) & (xs < w - bw) & (ys >= bh) & (ys < h - bh)).float()[:, None]
    mask = keep * inside
    return images * mask, flows * mask


# ---------------------------------------------------------------------------
# Chromatic-eigen augmentation (the reference's eigenspace pow/add/mult on
# luminance / saturation / color axes; ComputeChromaticEigenspace and
# ChromaticEigenAugmentation, data_augmentation_layer.cu:119-290, statistics
# finalized at :495-535)
# ---------------------------------------------------------------------------

# Default RGB eigenvectors of natural-image statistics (rows = eigenvectors;
# the released FlowNet2 training templates pass these as chromatic_eigvec).
DEFAULT_CHROMATIC_EIGVEC = np.asarray(
    [
        [0.51, 0.56, 0.65],
        [0.79, 0.01, -0.62],
        [0.35, -0.83, 0.44],
    ],
    np.float32,
)


@dataclass
class ChromaticEigenCoeffs:
    """Per-item coefficients (AugmentationCoeff eigen fields). Defaults are
    the identity transform."""

    pow_nomean: tuple[float, float, float] = (1.0, 1.0, 1.0)
    add_nomean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    mult_nomean: tuple[float, float, float] = (1.0, 1.0, 1.0)
    pow_withmean: tuple[float, float, float] = (1.0, 1.0, 1.0)
    add_withmean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    mult_withmean: tuple[float, float, float] = (1.0, 1.0, 1.0)
    lmult_pow: float = 1.0
    lmult_add: float = 0.0
    lmult_mult: float = 1.0
    col_angle: float = 0.0


@dataclass(frozen=True)
class ChromaticEigenAugSpec:
    """Sampling spec; field mapping per generate_chromatic_eigen_coeffs
    (augmentation_layer_base.cpp:264-312): ladd_* drive the nomean[0] and
    (pow only, via defaults) withmean[0] channel, col_* drive nomean[1,2],
    sat_* drive withmean[1,2], lmult_* the final luminance path."""

    ladd_pow: Optional[RandomSpec] = None
    ladd_add: Optional[RandomSpec] = None
    ladd_mult: Optional[RandomSpec] = None
    col_pow: Optional[RandomSpec] = None
    col_add: Optional[RandomSpec] = None
    col_mult: Optional[RandomSpec] = None
    sat_pow: Optional[RandomSpec] = None
    sat_add: Optional[RandomSpec] = None
    sat_mult: Optional[RandomSpec] = None
    lmult_pow: Optional[RandomSpec] = None
    lmult_add: Optional[RandomSpec] = None
    lmult_mult: Optional[RandomSpec] = None
    col_rotate: Optional[RandomSpec] = None

    def any(self) -> bool:
        return any(
            getattr(self, n) is not None
            for n in (
                "ladd_pow", "ladd_add", "ladd_mult", "col_pow", "col_add",
                "col_mult", "sat_pow", "sat_add", "sat_mult", "lmult_pow",
                "lmult_add", "lmult_mult", "col_rotate",
            )
        )

    def sample(self, rng: np.random.Generator, discount: float = 1.0) -> ChromaticEigenCoeffs:
        c = ChromaticEigenCoeffs()

        def s(spec):
            return spec.sample(rng, discount)

        pn = list(c.pow_nomean); an = list(c.add_nomean); mn = list(c.mult_nomean)
        pw = list(c.pow_withmean); aw = list(c.add_withmean); mw = list(c.mult_withmean)
        if self.ladd_pow is not None:
            pn[0] = s(self.ladd_pow)
        if self.col_pow is not None:
            pn[1] = s(self.col_pow)
            pn[2] = s(self.col_pow)
        if self.ladd_add is not None:
            an[0] = s(self.ladd_add)
        if self.col_add is not None:
            an[1] = s(self.col_add)
            an[2] = s(self.col_add)
        if self.ladd_mult is not None:
            mn[0] = s(self.ladd_mult)
        if self.col_mult is not None:
            mn[1] = s(self.col_mult)
            mn[2] = s(self.col_mult)
        if self.sat_pow is not None:
            pw[1] = pw[2] = s(self.sat_pow)
        if self.sat_add is not None:
            aw[1] = aw[2] = s(self.sat_add)
        if self.sat_mult is not None:
            mw[1] = mw[2] = s(self.sat_mult)
        c.pow_nomean = tuple(pn); c.add_nomean = tuple(an); c.mult_nomean = tuple(mn)
        c.pow_withmean = tuple(pw); c.add_withmean = tuple(aw); c.mult_withmean = tuple(mw)
        if self.lmult_pow is not None:
            c.lmult_pow = s(self.lmult_pow)
        if self.lmult_add is not None:
            c.lmult_add = s(self.lmult_add)
        if self.lmult_mult is not None:
            c.lmult_mult = s(self.lmult_mult)
        if self.col_rotate is not None:
            c.col_angle = s(self.col_rotate)
        return c


def _signed_pow(x, p):
    return torch.sign(x) * torch.abs(x) ** p


def apply_chromatic_eigen_transform(
    images: torch.Tensor,
    coeffs: dict[str, torch.Tensor],
    *,
    eigvec: np.ndarray = DEFAULT_CHROMATIC_EIGVEC,
    max_multiplier: float = 1.0,
) -> torch.Tensor:
    """Batched eigenspace chromatic transform.

    images: (N, 3, H, W) in [0, max_multiplier]. ``coeffs`` (stacked per
    item): pow_nomean/add_nomean/mult_nomean/pow_withmean/add_withmean/
    mult_withmean (N, 3), lmult_pow/lmult_add/lmult_mult/col_angle (N,).
    The statistics (mean_rgb, max_abs_eig, max_l) are over the whole batch,
    as the reference's single shared eigenspace struct. The arithmetic runs
    channels-last, in the JAX code's order.
    """
    x = images.float().permute(0, 2, 3, 1)
    ev = torch.as_tensor(eigvec, dtype=torch.float32, device=images.device)  # (3 eig, 3 rgb)
    one = torch.ones((), device=images.device)

    eig_all = torch.einsum("er,nhwr->nhwe", ev, x)
    mean_rgb = torch.mean(x, dim=(0, 1, 2))  # (3,)
    max_abs_eig = torch.amax(torch.abs(eig_all), dim=(0, 1, 2))  # (3,)
    mean_eig = ev @ mean_rgb
    big = max_abs_eig > 1e-2
    mean_eig = torch.where(big, mean_eig / torch.where(big, max_abs_eig, one), mean_eig)
    max_l = torch.sqrt(torch.sum(torch.square(max_abs_eig)))

    def bcast(v):  # (N, k) -> (N, 1, 1, k)
        return v[:, None, None]

    def item(v):  # (N,) -> (N, 1, 1)
        return v[:, None, None]

    rgb = x - mean_rgb
    eig = torch.einsum("er,nhwr->nhwe", ev, rgb)

    # nomean: normalize, signed pow, add, mult (per eigen channel)
    e_norm = eig / torch.where(big, max_abs_eig, one)
    e_tr = _signed_pow(e_norm, bcast(coeffs["pow_nomean"]))
    e_tr = (e_tr + bcast(coeffs["add_nomean"])) * bcast(coeffs["mult_nomean"])
    eig = torch.where(big, e_tr, eig)

    # re-add the normalized mean
    eig = eig + mean_eig

    # withmean channel 0 (the luminance axis)
    e0 = _signed_pow(eig[..., 0], item(coeffs["pow_withmean"][:, 0]))
    e0 = (e0 + item(coeffs["add_withmean"][:, 0])) * item(coeffs["mult_withmean"][:, 0])
    eig = torch.where(big[0], torch.stack([e0, eig[..., 1], eig[..., 2]], dim=-1), eig)

    # saturation on channels 1, 2
    s = torch.sqrt(torch.square(eig[..., 1]) + torch.square(eig[..., 2]))
    s_big = s > 1e-2
    s1 = s ** item(coeffs["pow_withmean"][:, 1])
    s1 = torch.clamp(s1 + item(coeffs["add_withmean"][:, 1]), min=0.0)
    s1 = s1 * item(coeffs["mult_withmean"][:, 1])
    s1 = torch.where(s_big, s1, s)

    # color rotation in the (1, 2) plane
    ang = item(coeffs["col_angle"])
    c1 = torch.cos(ang) * eig[..., 1] - torch.sin(ang) * eig[..., 2]
    c2 = torch.sin(ang) * eig[..., 1] + torch.cos(ang) * eig[..., 2]
    eig = torch.stack([eig[..., 0], c1, c2], dim=-1)

    # un-normalize
    eig = eig * torch.where(big, max_abs_eig, one)

    l_big = max_l > 1e-2
    l1_pre = torch.sqrt(torch.sum(torch.square(eig), dim=-1)) / torch.where(l_big, max_l, one)

    # saturation rescale
    s_safe = torch.where(s_big, s, one)
    e1 = torch.where(s_big, eig[..., 1] / s_safe * s1, eig[..., 1])
    e2 = torch.where(s_big, eig[..., 2] / s_safe * s1, eig[..., 2])
    eig = torch.stack([eig[..., 0], e1, e2], dim=-1)

    # luminance rescale
    lum = torch.sqrt(torch.sum(torch.square(eig), dim=-1))
    l1 = l1_pre ** item(coeffs["lmult_pow"])
    l1 = torch.clamp(l1 + item(coeffs["lmult_add"]), min=0.0)
    l1 = l1 * item(coeffs["lmult_mult"]) * max_l
    l_px_big = lum > 1e-2
    scale = torch.where(l_px_big & l_big, l1 / torch.where(l_px_big, lum, one), one)
    eig_scaled = torch.minimum(eig * scale[..., None], max_abs_eig)
    eig = torch.where(l_big, eig_scaled, eig)

    # reconstruction: rgb[c] = sum_e eigvec[e, c] * eig[e] (cu:285-288)
    out = torch.einsum("ec,nhwe->nhwc", ev, eig)
    out = torch.clamp(out, 0.0, max_multiplier)
    return out.permute(0, 3, 1, 2).to(images.dtype)


def apply_shadow(
    images: torch.Tensor,
    shadow_nx: torch.Tensor,
    shadow_ny: torch.Tensor,
    shadow_distance: torch.Tensor,
    shadow_strength: torch.Tensor,
    *,
    max_multiplier: float = 1.0,
) -> torch.Tensor:
    """The reference's effect kernel (ApplyEffects,
    data_augmentation_layer.cu:296-318): darken the half-plane
    (x - W/2)*nx + (y - H/2)*ny > distance by ``strength``, then clamp.
    Fog and motion blur are sampled but never applied, as in the reference.
    Per item (N,): nx/ny (cos/sin of shadow_angle), distance, strength.
    """
    n, _, h, w = images.shape
    xs, ys = _pixel_grid(h, w, images.device)
    plane = (xs - w / 2) * shadow_nx[:, None, None] + (ys - h / 2) * shadow_ny[:, None, None] - shadow_distance[
        :, None, None
    ]
    shaded = images.float() - (plane > 0)[:, None] * shadow_strength[:, None, None, None]
    return torch.clamp(shaded, 0.0, max_multiplier).to(images.dtype)


# ---------------------------------------------------------------------------
# Vectorized host sampling (the training loader's path)
# ---------------------------------------------------------------------------


def _sample_spec_n(spec: Optional[RandomSpec], rng: np.random.Generator, n: int, discount: float) -> np.ndarray:
    """Vectorized RandomSpec sampling: n draws at once (the distributions of
    RandomSpec.sample; the draw ORDER differs from the reference's scalar
    sequence)."""
    if spec is None:
        return np.zeros(n, np.float64)
    spread = spec.spread * discount if spec.apply_schedule else spec.spread
    t = spec.rand_type
    if t == "uniform":
        v = rng.uniform(spec.mean - spread, spec.mean + spread, n) if spread > 0 else np.full(n, spec.mean)
        if spec.exp:
            v = np.exp(v)
    elif t == "gaussian":
        v = rng.normal(spec.mean, spread, n) if spread > 0 else np.full(n, spec.mean)
        if spec.exp:
            v = np.exp(v)
    elif t == "bernoulli":
        v = (rng.uniform(size=n) < spec.prob).astype(np.float64) if spec.prob > 0 else np.zeros(n)
    elif t in ("uniform_bernoulli", "gaussian_bernoulli"):
        on = (rng.uniform(size=n) < spec.prob) if spec.prob > 0 else np.zeros(n, bool)
        if spread > 0:
            raw = (
                rng.uniform(spec.mean - spread, spec.mean + spread, n)
                if t == "uniform_bernoulli"
                else rng.normal(spec.mean, spread, n)
            )
        else:
            raw = np.full(n, spec.mean)
        v = np.where(on, raw, 0.0)
        if spec.exp:
            v = np.exp(v)
    else:
        raise ValueError(f"unknown rand_type {t!r}")
    if spec.discretize:
        v = np.round(v)
    return spec.multiplier * v


def spatial_corner_valid(mirror, dx, dy, angle, zx, zy, *, crop_w, crop_h, src_w, src_h):
    """Vectorized corner validity of candidate spatial coeffs: all 4 crop
    corners land inside the source (generate_valid_spatial_coeffs' corner
    math, augmentation_layer_base.cpp:101-169)."""
    valid = np.ones(np.shape(angle), bool)
    for cx in (0, crop_w - 1):
        for cy in (0, crop_h - 1):
            x1 = np.where(mirror.astype(bool), -cx + 0.5 * crop_w, cx - 0.5 * crop_w)
            y1 = cy - 0.5 * crop_h
            ca, sa = np.cos(angle), np.sin(angle)
            x2 = ca * x1 - sa * y1 + dx * crop_w
            y2 = sa * x1 + ca * y1 + dy * crop_h
            x2 = x2 / zx + 0.5 * src_w
            y2 = y2 / zy + 0.5 * src_h
            valid &= (np.floor(x2) >= 0) & (np.floor(x2) <= src_w - 2)
            valid &= (np.floor(y2) >= 0) & (np.floor(y2) <= src_h - 2)
    return valid


def sample_valid_spatial_coeffs_batch(
    spec: SpatialAugSpec,
    rng: np.random.Generator,
    *,
    n_items: int,
    crop_w: int,
    crop_h: int,
    src_w: int,
    src_h: int,
    discount: float = 1.0,
    base: Optional[np.ndarray] = None,
    max_tries: int = 50,
) -> np.ndarray:
    """Vectorized rejection sampling: (n_items, 6) coeff rows
    [mirror, dx, dy, angle, zoom_x, zoom_y], all candidates evaluated at once.

    ``base``: optional (n_items, 6) incoming coeffs composed additively (the
    img2-relative mode). Items with no valid candidate fall back to base /
    identity, as the reference's max-tries path does. The port's warp is
    exact at every affine, so no candidate is rejected for its warp.
    """
    k = max_tries
    total = n_items * k
    mirror = _sample_spec_n(spec.mirror, rng, total, discount)
    if spec.translate is not None:
        dx = _sample_spec_n(spec.translate, rng, total, discount)
        dy = _sample_spec_n(spec.translate, rng, total, discount)
    else:
        dx = np.zeros(total)
        dy = np.zeros(total)
    if spec.translate_x is not None:
        dx = _sample_spec_n(spec.translate_x, rng, total, discount)
    if spec.translate_y is not None:
        dy = _sample_spec_n(spec.translate_y, rng, total, discount)
    angle = _sample_spec_n(spec.rotate, rng, total, discount)
    if spec.zoom is not None:
        zx = _sample_spec_n(spec.zoom, rng, total, discount)
    else:
        zx = np.ones(total)
    zy = zx.copy()
    if spec.squeeze is not None:
        sq = _sample_spec_n(spec.squeeze, rng, total, discount)
        zx = zx * sq
        zy = zy / sq

    if base is not None:
        b = np.repeat(np.asarray(base, np.float64), k, axis=0)
        mirror = (mirror.astype(bool) ^ b[:, 0].astype(bool)).astype(np.float64)
        dx = dx + b[:, 1]
        dy = dy + b[:, 2]
        angle = angle + b[:, 3]
        zx = zx * np.where(b[:, 4] == 0, 1.0, b[:, 4])
        zy = zy * np.where(b[:, 5] == 0, 1.0, b[:, 5])

    valid = spatial_corner_valid(
        mirror, dx, dy, angle, zx, zy, crop_w=crop_w, crop_h=crop_h, src_w=src_w, src_h=src_h
    )
    cand = np.stack([mirror, dx, dy, angle, zx, zy], axis=1).reshape(n_items, k, 6)
    valid = valid.reshape(n_items, k)
    first = np.argmax(valid, axis=1)
    any_valid = valid.any(axis=1)
    out = cand[np.arange(n_items), first]
    fallback = (
        np.asarray(base, np.float64)
        if base is not None
        else np.tile(np.asarray([0, 0, 0, 0, 1, 1], np.float64), (n_items, 1))
    )
    out = np.where(any_valid[:, None], out, fallback)
    return out.astype(np.float32)
