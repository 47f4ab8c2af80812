"""Augmentation-coefficient arrays: the reference's coeff-blob contract
(flownet2_tpu/data/aug_params.py, numpy only; its sampling goes through the
port's ops/augment, so one seeded generator gives the JAX module's arrays).

The reference serializes per-item ``AugmentationCoeff`` protos into flat
float arrays (one slot per proto field, declaration order) so augmentation
layers can emit coefficients as a top blob and consume them as a bottom
blob (data_augmentation_layer.cu:349-350). Multiplicative fields (proto
default 1) are stored in LOG space so that plain array addition composes
them multiplicatively (coeff_to_array/array_to_coeff,
augmentation_layer_base.cpp:352-379).

This module reproduces that contract in numpy, plus the standalone
parameter generator (``GenerateAugmentationParameters``,
generate_augmentation_parameters_layer.{cpp,cu}) with ALL THREE modes:

- ``add``        — fresh coefficients are added (log-space ⇒ composed) onto
                   the incoming array; spatial sampling rejection-checks the
                   COMPOSED transform against the source bounds;
- ``replace``    — incoming spatial fields are cleared before sampling
                   (fresh spatial replaces them); chromatic/eigen/effect
                   fields are overwritten by fresh samples; fields not being
                   generated keep their incoming values;
- ``regenerate`` — the whole array is zeroed (identity) first.

Reference: generate_augmentation_parameters_layer.cu:62-115.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from flownet2_tpu_torch.ops.augment import (
    ChromaticAugSpec,
    ChromaticCoeffs,
    ChromaticEigenAugSpec,
    ChromaticEigenCoeffs,
    EffectAugSpec,
    SpatialAugSpec,
    SpatialCoeffs,
    crop_fits,
)

# (field name, proto default) in DECLARATION order of message AugmentationCoeff
# (caffe.proto:436-486) — the reflection iteration order coeff_to_array uses.
COEFF_FIELDS: tuple[tuple[str, float], ...] = (
    ("mirror", 0.0),
    ("dx", 0.0),
    ("dy", 0.0),
    ("angle", 0.0),
    ("zoom_x", 1.0),
    ("zoom_y", 1.0),
    ("gamma", 1.0),
    ("brightness", 0.0),
    ("contrast", 1.0),
    ("color1", 1.0),
    ("color2", 1.0),
    ("color3", 1.0),
    ("pow_nomean0", 1.0),
    ("pow_nomean1", 1.0),
    ("pow_nomean2", 1.0),
    ("add_nomean0", 0.0),
    ("add_nomean1", 0.0),
    ("add_nomean2", 0.0),
    ("mult_nomean0", 1.0),
    ("mult_nomean1", 1.0),
    ("mult_nomean2", 1.0),
    ("pow_withmean0", 1.0),
    ("pow_withmean1", 1.0),
    ("pow_withmean2", 1.0),
    ("add_withmean0", 0.0),
    ("add_withmean1", 0.0),
    ("add_withmean2", 0.0),
    ("mult_withmean0", 1.0),
    ("mult_withmean1", 1.0),
    ("mult_withmean2", 1.0),
    ("lmult_pow", 1.0),
    ("lmult_add", 0.0),
    ("lmult_mult", 1.0),
    ("col_angle", 0.0),
    ("fog_amount", 0.0),
    ("fog_size", 0.0),
    ("motion_blur_angle", 0.0),
    ("motion_blur_size", 0.0),
    ("shadow_angle", 0.0),
    ("shadow_distance", 0.0),
    ("shadow_strength", 0.0),
    ("noise", 0.0),
)
NUM_COEFFS = len(COEFF_FIELDS)
_INDEX = {name: i for i, (name, _) in enumerate(COEFF_FIELDS)}
# default != 0 → multiplicative → stored as log(value)
_IS_LOG = np.asarray([abs(d) >= 1e-3 for _, d in COEFF_FIELDS])
_DEFAULTS = np.asarray([d for _, d in COEFF_FIELDS], np.float64)

_SPATIAL = ("mirror", "dx", "dy", "angle", "zoom_x", "zoom_y")
_CHROMATIC = ("gamma", "brightness", "contrast", "color1", "color2", "color3")
_EIGEN = tuple(n for n, _ in COEFF_FIELDS[12:34])
_EFFECT = tuple(n for n, _ in COEFF_FIELDS[34:])


@dataclass
class FullCoeffs:
    """One item's complete coefficient set (= one AugmentationCoeff)."""

    spatial: SpatialCoeffs
    chromatic: ChromaticCoeffs
    eigen: ChromaticEigenCoeffs
    fog_amount: float = 0.0
    fog_size: float = 0.0
    motion_blur_angle: float = 0.0
    motion_blur_size: float = 0.0
    shadow_angle: float = 0.0
    shadow_distance: float = 0.0
    shadow_strength: float = 0.0
    noise: float = 0.0

    @staticmethod
    def identity() -> "FullCoeffs":
        return FullCoeffs(SpatialCoeffs(), ChromaticCoeffs(), ChromaticEigenCoeffs())


def _field_values(c: FullCoeffs) -> np.ndarray:
    s, ch, e = c.spatial, c.chromatic, c.eigen
    vals = [
        s.mirror, s.dx, s.dy, s.angle, s.zoom_x, s.zoom_y,
        ch.gamma, ch.brightness, ch.contrast, *ch.color,
        *e.pow_nomean, *e.add_nomean, *e.mult_nomean,
        *e.pow_withmean, *e.add_withmean, *e.mult_withmean,
        e.lmult_pow, e.lmult_add, e.lmult_mult, e.col_angle,
        c.fog_amount, c.fog_size, c.motion_blur_angle, c.motion_blur_size,
        c.shadow_angle, c.shadow_distance, c.shadow_strength, c.noise,
    ]
    return np.asarray(vals, np.float64)


def coeffs_to_array(c: FullCoeffs) -> np.ndarray:
    """FullCoeffs → (NUM_COEFFS,) float32, log-space for multiplicative
    fields (coeff_to_array, augmentation_layer_base.cpp:352-366)."""
    vals = _field_values(c)
    out = np.where(_IS_LOG, np.log(np.where(_IS_LOG, vals, 1.0)), vals)
    return out.astype(np.float32)


def array_to_coeffs(arr: np.ndarray) -> FullCoeffs:
    """(NUM_COEFFS,) array → FullCoeffs (array_to_coeff,
    augmentation_layer_base.cpp:368-379)."""
    arr = np.asarray(arr, np.float64)
    vals = np.where(_IS_LOG, np.exp(arr), arr)
    g = lambda name: float(vals[_INDEX[name]])
    spatial = SpatialCoeffs(
        mirror=g("mirror"), dx=g("dx"), dy=g("dy"), angle=g("angle"),
        zoom_x=g("zoom_x"), zoom_y=g("zoom_y"),
    )
    chromatic = ChromaticCoeffs(
        gamma=g("gamma"), brightness=g("brightness"), contrast=g("contrast"),
        color=(g("color1"), g("color2"), g("color3")),
    )
    eigen = ChromaticEigenCoeffs(
        pow_nomean=tuple(g(f"pow_nomean{i}") for i in range(3)),
        add_nomean=tuple(g(f"add_nomean{i}") for i in range(3)),
        mult_nomean=tuple(g(f"mult_nomean{i}") for i in range(3)),
        pow_withmean=tuple(g(f"pow_withmean{i}") for i in range(3)),
        add_withmean=tuple(g(f"add_withmean{i}") for i in range(3)),
        mult_withmean=tuple(g(f"mult_withmean{i}") for i in range(3)),
        lmult_pow=g("lmult_pow"), lmult_add=g("lmult_add"),
        lmult_mult=g("lmult_mult"), col_angle=g("col_angle"),
    )
    return FullCoeffs(
        spatial, chromatic, eigen,
        fog_amount=g("fog_amount"), fog_size=g("fog_size"),
        motion_blur_angle=g("motion_blur_angle"),
        motion_blur_size=g("motion_blur_size"),
        shadow_angle=g("shadow_angle"), shadow_distance=g("shadow_distance"),
        shadow_strength=g("shadow_strength"), noise=g("noise"),
    )


def identity_array() -> np.ndarray:
    """The all-cleared coefficient array (clear_all_coeffs: every field at
    its default; log(1)=0 ⇒ the array is all zeros)."""
    return np.zeros((NUM_COEFFS,), np.float32)


def _clear_fields(arr: np.ndarray, names: tuple[str, ...]) -> np.ndarray:
    out = arr.copy()
    for n in names:
        out[_INDEX[n]] = 0.0  # log-space identity for mult fields too
    return out


@dataclass(frozen=True)
class AugSpecBundle:
    """All sampling specs the generator layer can carry (AugmentationParameter)."""

    spatial: Optional[SpatialAugSpec] = None
    chromatic: Optional[ChromaticAugSpec] = None
    eigen: Optional[ChromaticEigenAugSpec] = None
    effect: Optional[EffectAugSpec] = None


def _sample_effect_array(spec: EffectAugSpec, rng: np.random.Generator, discount: float) -> np.ndarray:
    """generate_effect_coeffs (augmentation_layer_base.cpp:313-336) as an
    array delta. Only samples the families the spec carries."""
    arr = identity_array()

    def put(name, rspec):
        if rspec is not None:
            arr[_INDEX[name]] = rspec.sample(rng, discount)

    put("noise", spec.noise)
    for name in ("fog_amount", "fog_size", "motion_blur_angle", "motion_blur_size",
                 "shadow_angle", "shadow_distance", "shadow_strength"):
        put(name, getattr(spec, name, None))
    return arr


def generate_augmentation_parameters(
    specs: AugSpecBundle,
    incoming: Optional[np.ndarray],
    *,
    mode: str = "add",
    rng: np.random.Generator,
    discount: float = 1.0,
    crop_w: int,
    crop_h: int,
    src_w: int,
    src_h: int,
    max_tries: int = 50,
) -> np.ndarray:
    """One item of the GenerateAugmentationParameters forward pass
    (generate_augmentation_parameters_layer.cu:62-115).

    ``incoming``: the bottom coeff array, or None (forces "regenerate",
    matching the 1-bottom/0-bottom layer convention, layer.cpp:56-66).
    Returns the (NUM_COEFFS,) output array.
    """
    if mode not in ("add", "replace", "regenerate"):
        raise ValueError(f"unknown mode {mode!r}")
    if incoming is None:
        mode = "regenerate"

    if mode in ("add", "replace"):
        arr = np.asarray(incoming, np.float32).copy()
    else:
        arr = identity_array()

    # Spatial: "replace" clears the incoming spatial fields first
    # (clear_spatial_coeffs, cu:70-71); then generate_valid_spatial_coeffs
    # composes fresh coeffs ON TOP of whatever spatial remains and
    # rejection-checks the 4 crop corners (augmentation_layer_base.cpp:
    # 101-169). On failure it keeps the incoming coeffs.
    if specs.spatial is not None and specs.spatial.any():
        if mode == "replace":
            arr = _clear_fields(arr, _SPATIAL)
        base = array_to_coeffs(arr).spatial
        accepted = base
        for _ in range(max_tries):
            fresh = specs.spatial.sample(rng, discount)
            cand = SpatialCoeffs(
                mirror=float(bool(fresh.mirror) != bool(base.mirror)),
                dx=fresh.dx + base.dx,
                dy=fresh.dy + base.dy,
                angle=fresh.angle + base.angle,
                zoom_x=fresh.zoom_x * base.zoom_x,
                zoom_y=fresh.zoom_y * base.zoom_y,
            )
            if crop_fits(cand, crop_w, crop_h, src_w, src_h):
                accepted = cand
                break
        arr = _write_spatial(arr, accepted)

    # Chromatic / eigen / effect: regenerate|replace OVERWRITE the fields;
    # add ADDS the fresh array delta (log-space ⇒ multiplicative compose)
    # — generate_augmentation_parameters_layer.cu:80-115.
    overwrite = mode in ("regenerate", "replace")
    if specs.chromatic is not None and specs.chromatic.any():
        fresh = specs.chromatic.sample(rng, discount)
        delta = coeffs_to_array(FullCoeffs(SpatialCoeffs(), fresh, ChromaticEigenCoeffs()))
        arr = _apply_family(arr, delta, _CHROMATIC, overwrite)
    if specs.eigen is not None and specs.eigen.any():
        fresh = specs.eigen.sample(rng, discount)
        delta = coeffs_to_array(FullCoeffs(SpatialCoeffs(), ChromaticCoeffs(), fresh))
        arr = _apply_family(arr, delta, _EIGEN, overwrite)
    if specs.effect is not None:
        delta = _sample_effect_array(specs.effect, rng, discount)
        arr = _apply_family(arr, delta, _EFFECT, overwrite)
    return arr


def _write_spatial(arr: np.ndarray, s: SpatialCoeffs) -> np.ndarray:
    out = arr.copy()
    out[_INDEX["mirror"]] = s.mirror
    out[_INDEX["dx"]] = s.dx
    out[_INDEX["dy"]] = s.dy
    out[_INDEX["angle"]] = s.angle
    out[_INDEX["zoom_x"]] = np.log(s.zoom_x)
    out[_INDEX["zoom_y"]] = np.log(s.zoom_y)
    return out


def _apply_family(arr: np.ndarray, delta: np.ndarray, names: tuple[str, ...], overwrite: bool) -> np.ndarray:
    out = arr.copy()
    idx = [_INDEX[n] for n in names]
    if overwrite:
        out[idx] = delta[idx]
    else:
        out[idx] = out[idx] + delta[idx]
    return out


def generate_augmentation_parameters_batch(
    specs: AugSpecBundle,
    incoming: Optional[np.ndarray],
    n_items: int,
    **kw,
) -> np.ndarray:
    """(n_items, NUM_COEFFS) batch of the generator (the layer's item loop)."""
    rows = []
    for i in range(n_items):
        inc = None if incoming is None else incoming[i]
        rows.append(generate_augmentation_parameters(specs, inc, **kw))
    return np.stack(rows, axis=0)
