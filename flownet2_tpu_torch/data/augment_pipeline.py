"""The training augmentation pipeline (flownet2_tpu/data/augment_pipeline.py):
host coefficient sampling and device application, joined to ``BatchLoader``
and the training objectives.

The reference's DataAugmentation / GenerateAugmentationParameters /
FlowAugmentation layer trio (SURVEY.md section 2.2):

- host (:func:`make_flownet_augmenter`, in the loader's worker threads):
  per-item valid spatial affines for frame 0, offset affines for frame 1
  (the paired coefficients of data_augmentation_layer.cu:349-350),
  chromatic coefficients and a noise std, attached to the batch as small
  arrays; the images stay at source resolution;
- device (:func:`apply_augmentation_device`, inside the objective under
  :func:`make_augmented_loss`): the affine sample of both images on the
  warp kernel K1, the consistent ground-truth flow transform, the
  chromatic transform, gaussian noise and the running mean, in float32.

The default distributions approximate the released FlowNet2 training
templates: translate +-0.4 (a fraction of the crop), rotate +-0.4 rad, zoom
exp(0.2 +- 0.4), squeeze exp(+-0.3), chromatic gamma / brightness /
contrast / color, gaussian noise up to 0.06.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from flownet2_tpu_torch.core.codec import flow_as_f32
from flownet2_tpu_torch.ops.augment import (
    ChromaticAugSpec,
    CoeffSchedule,
    EffectAugSpec,
    RandomSpec,
    SpatialAugSpec,
    SpatialCoeffs,
    _sample_spec_n,
    apply_chromatic_transform,
    apply_flow_augmentation,
    apply_gaussian_noise,
    apply_spatial_transform,
    invert_affine,
    sample_valid_spatial_coeffs_batch,
    spatial_matrix,
)

MEAN_KEYS = ("mean_image0", "mean_image1")
BATCH_MEAN_KEYS = ("aug_batch_mean0", "aug_batch_mean1")


@dataclass(frozen=True)
class FlowNetAugConfig:
    spatial: SpatialAugSpec = SpatialAugSpec(
        mirror=None,  # mirroring breaks flow sign conventions; the reference nets omit it
        translate=RandomSpec("uniform_bernoulli", mean=0.0, spread=0.4, prob=1.0),
        rotate=RandomSpec("uniform_bernoulli", mean=0.0, spread=0.4, prob=1.0),
        zoom=RandomSpec("uniform_bernoulli", exp=True, mean=0.2, spread=0.4, prob=1.0),
        squeeze=RandomSpec("uniform_bernoulli", exp=True, mean=0.0, spread=0.3, prob=1.0),
    )
    # frame 1's offset relative to frame 0 (GenerateAugmentationParameters'
    # "add" mode): a small relative translate / rotate / zoom
    spatial_offset: SpatialAugSpec = SpatialAugSpec(
        translate=RandomSpec("gaussian_bernoulli", mean=0.0, spread=0.03, prob=1.0),
        rotate=RandomSpec("gaussian_bernoulli", mean=0.0, spread=0.03, prob=1.0),
        zoom=RandomSpec("gaussian_bernoulli", exp=True, mean=0.0, spread=0.03, prob=1.0),
    )
    chromatic: ChromaticAugSpec = ChromaticAugSpec(
        gamma=RandomSpec("gaussian_bernoulli", exp=True, mean=0.0, spread=0.02, prob=1.0),
        brightness=RandomSpec("gaussian_bernoulli", mean=0.0, spread=0.02, prob=1.0),
        contrast=RandomSpec("gaussian_bernoulli", exp=True, mean=0.0, spread=0.02, prob=1.0),
        color=RandomSpec("gaussian_bernoulli", exp=True, mean=0.0, spread=0.02, prob=1.0),
    )
    effect: EffectAugSpec = EffectAugSpec(noise=RandomSpec("uniform_bernoulli", mean=0.03, spread=0.03, prob=1.0))
    schedule: CoeffSchedule = CoeffSchedule(half_life=50000, initial_coeff=0.5, final_coeff=1.0)


def sample_aug_arrays(
    config: FlowNetAugConfig,
    rng: np.random.Generator,
    n: int,
    src_h: int,
    src_w: int,
    crop_h: int,
    crop_w: int,
    discount: float = 1.0,
) -> dict:
    """The per-item augmentation arrays of a batch of ``n`` items at source
    resolution (src_h, src_w): the ``aug_*`` dict that
    :func:`apply_augmentation_device` consumes. They depend on the geometry
    alone, not on the pixels."""
    geo = dict(crop_w=crop_w, crop_h=crop_h, src_w=src_w, src_h=src_h)
    c0 = sample_valid_spatial_coeffs_batch(config.spatial, rng, n_items=n, discount=discount, **geo)
    c1 = sample_valid_spatial_coeffs_batch(config.spatial_offset, rng, n_items=n, discount=discount, base=c0, **geo)
    m0 = np.zeros((n, 6), np.float32)
    m1 = np.zeros((n, 6), np.float32)
    inv1 = np.zeros((n, 6), np.float32)
    for i in range(n):
        m0[i] = spatial_matrix(SpatialCoeffs(*(float(v) for v in c0[i])), crop_w, crop_h, src_w, src_h)
        m1[i] = spatial_matrix(SpatialCoeffs(*(float(v) for v in c1[i])), crop_w, crop_h, src_w, src_h)
        inv1[i] = invert_affine(m1[i])

    ch = config.chromatic
    one = np.ones((n,), np.float32)
    gamma = _sample_spec_n(ch.gamma, rng, n, discount).astype(np.float32) if ch.gamma else one
    brightness = _sample_spec_n(ch.brightness, rng, n, discount).astype(np.float32) if ch.brightness else one * 0
    contrast = _sample_spec_n(ch.contrast, rng, n, discount).astype(np.float32) if ch.contrast else one
    if ch.color is not None:
        color = np.stack([_sample_spec_n(ch.color, rng, n, discount) for _ in range(3)], axis=1).astype(np.float32)
    else:
        color = np.ones((n, 3), np.float32)
    if config.effect.noise is not None:
        noise = np.maximum(_sample_spec_n(config.effect.noise, rng, n, discount), 0.0).astype(np.float32)
    else:
        noise = np.zeros((n,), np.float32)
    return dict(
        aug_mat0=m0,
        aug_mat1=m1,
        aug_inv_mat1=inv1,
        aug_gamma=gamma,
        aug_brightness=brightness,
        aug_contrast=contrast,
        aug_color=color,
        aug_noise=noise,
    )


def make_flownet_augmenter(
    crop_h: int, crop_w: int, config: FlowNetAugConfig = FlowNetAugConfig()
) -> Callable[[dict, np.random.Generator], dict]:
    """The ``BatchLoader`` transform that attaches the per-item arrays:
    aug_mat0 / aug_mat1 (N, 6) crop -> source affines of each frame,
    aug_inv_mat1 (N, 6) frame 1's source -> crop affine,
    aug_gamma / aug_brightness / aug_contrast (N,), aug_color (N, 3),
    aug_noise (N,). The images and the flow stay at source resolution; the
    device makes the crops.

    ``rows=(lo, hi, n)`` (a keyed ``BatchLoader``'s shard): the batch holds
    rows [lo, hi) of a global batch of n items; the coefficients of all n
    are drawn and those rows kept, so every rank's rows carry the
    coefficients one process would draw for the global batch."""

    def transform(batch: dict, rng: np.random.Generator, rows: Optional[tuple[int, int, int]] = None) -> dict:
        n, src_h, src_w = batch["img0"].shape[:3]
        lo, hi, total = rows if rows is not None else (0, n, n)
        if hi - lo != n:
            raise ValueError(f"rows {rows} do not match a batch of {n}")
        arrays = sample_aug_arrays(config, rng, total, src_h, src_w, crop_h, crop_w)
        batch = dict(batch)
        batch.update({k: v[lo:hi] for k, v in arrays.items()})
        return batch

    return transform


def apply_augmentation_device(
    batch: dict,
    generator: torch.Generator,
    crop_h: int,
    crop_w: int,
    *,
    mean_window: int = 0,
    mean_per_pixel: bool = False,
    sample_dtype: torch.dtype = torch.float32,
) -> dict:
    """The device side: consumes the aug_* arrays of a batch of NHWC
    tensors (images uint8 or float in 0-255, flow float32 or int16
    transport, decoded here on the device); returns NCHW ``img0`` / ``img1``
    at crop resolution, still in 0-255 (the chromatic transforms run in
    [0, 1], as the reference's training nets rescale by 1/255 first), and
    float32 ``flow`` (N, 2, crop_h, crop_w). ``generator`` draws the noise,
    frame 0's then frame 1's.

    Mean handling (data_augmentation_layer.cu:592-635): with
    ``mean_image0``/``mean_image1`` and ``mean_iter`` in the batch
    (:class:`~flownet2_tpu_torch.data.mean.MeanRecompute.attach`), the
    running mean updates and is subtracted, and each frame's batch mean
    comes back as ``aug_batch_mean0/1`` for the host mirror; a ``mean_rgb``
    entry subtracts a fixed per-channel mean instead. Both in [0, 1].

    ``sample_dtype``: the images' affine sample in float32 (the default) or
    in bfloat16, the JAX package's accelerator route
    (:func:`~flownet2_tpu_torch.ops.augment.apply_spatial_transform`); the
    flow transform, chromatic and noise stay float32.
    """
    from flownet2_tpu_torch.data.mean import recompute_mean_and_subtract, subtract_fixed_mean

    def nchw_unit(x):
        return x.permute(0, 3, 1, 2).float() / 255.0

    img0 = apply_spatial_transform(nchw_unit(batch["img0"]), batch["aug_mat0"], crop_h, crop_w,
                                   sample_dtype=sample_dtype)
    img1 = apply_spatial_transform(nchw_unit(batch["img1"]), batch["aug_mat1"], crop_h, crop_w,
                                   sample_dtype=sample_dtype)
    flow = apply_flow_augmentation(
        flow_as_f32(batch["flow"]).permute(0, 3, 1, 2), batch["aug_mat0"], batch["aug_inv_mat1"], crop_h, crop_w
    )
    chromatic = [batch[k] for k in ("aug_gamma", "aug_brightness", "aug_contrast", "aug_color")]
    img0 = apply_gaussian_noise(apply_chromatic_transform(img0, *chromatic), batch["aug_noise"], generator)
    img1 = apply_gaussian_noise(apply_chromatic_transform(img1, *chromatic), batch["aug_noise"], generator)

    imgs, extra = [img0, img1], {}
    if any(k in batch for k in MEAN_KEYS):
        for i, (key, out_key) in enumerate(zip(MEAN_KEYS, BATCH_MEAN_KEYS)):
            if key in batch:
                imgs[i], extra[out_key] = recompute_mean_and_subtract(
                    imgs[i], batch[key], batch["mean_iter"], window=mean_window, per_pixel=mean_per_pixel
                )
    elif "mean_rgb" in batch:
        imgs = [subtract_fixed_mean(img, batch["mean_rgb"]) for img in imgs]
    return {"img0": imgs[0] * 255.0, "img1": imgs[1] * 255.0, "flow": flow, **extra}


def write_augmented(
    batch: dict,
    folder: str,
    iteration: int,
    crop_h: int,
    crop_w: int,
    *,
    log: Callable[[str], None] = print,
    device="cpu",
) -> list[str]:
    """The ``write_augmented`` debug option (AugmentationParameter,
    caffe.proto:492; data_augmentation_layer.cu:413-439): log the sampled
    coefficients per item and write the augmented images.

    Runs the augmentation on ``device`` on the host batch (a debug path,
    outside the train step; the noise generator seeded with ``iteration``)
    and writes ``{folder}/aug0_NNNNNNN(nnn).ppm`` / ``aug1_...`` through
    :class:`~flownet2_tpu_torch.tools.writers.Writer`. Returns the paths.
    """
    from flownet2_tpu_torch.tools.writers import Writer

    n = batch["img0"].shape[0]
    for i in range(n):
        m = np.asarray(batch["aug_mat0"][i])
        log(
            f"Augmenting {i}, affine0: [{', '.join(f'{v:.4f}' for v in m)}], "
            f"gamma: {float(batch['aug_gamma'][i]):.4f}, "
            f"brightness: {float(batch['aug_brightness'][i]):.4f}, "
            f"contrast: {float(batch['aug_contrast'][i]):.4f}, "
            f"color: {np.asarray(batch['aug_color'][i]).round(4).tolist()}, "
            f"noise: {float(batch['aug_noise'][i]):.4f}"
        )
    on_device = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
    generator = torch.Generator(device=device).manual_seed(iteration)
    with torch.no_grad():
        out = apply_augmentation_device(on_device, generator, crop_h, crop_w)
    paths = []
    for name in ("img0", "img1"):
        w = Writer(folder, kind="img", prefix=f"aug{name[-1]}_")
        paths += w(out[name].permute(0, 2, 3, 1).cpu().numpy(), iteration)
    return paths


def noise_seed(seed: int, rank: int) -> int:
    """The noise generator's seed on ``rank``: ``seed`` itself on rank 0, as
    in one process; on the other ranks one drawn from (seed, rank), so that
    no two ranks add the same noise field to their different pairs."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def make_augmented_loss(
    base_loss: Callable,
    crop_h: int,
    crop_w: int,
    seed: int = 0,
    *,
    mean_window: int = 0,
    mean_per_pixel: bool = False,
    rank: int = 0,
    sample_dtype: torch.dtype = torch.float32,
) -> Callable:
    """Wrap an objective ``base_loss(net, batch)`` so that it augments the
    batch first, when the batch carries the aug_* arrays (else it passes
    the batch through).

    The augmentation runs under ``torch.no_grad()`` in float32: no backward
    of K1 is recorded, and a ``with_compute_dtype`` objective inside casts
    only its output. The base loss gets NHWC views of the NCHW results (its
    own NCHW conversion then copies nothing) and ``frozen``, if the batch
    has it. With a running mean attached, the per-frame batch means come
    back in the aux dict as ``aug_batch_mean0/1`` for the host mirrors.

    The noise comes from one generator on the batch's device, seeded with
    ``noise_seed(seed, rank)`` at the first call and advancing from call to
    call, so drawing it never waits for the device: each rank of a
    data-parallel group draws its own noise fields, and rank 0 those of one
    process. A resumed run draws the stream afresh, as its loader starts
    its epochs afresh. ``sample_dtype`` goes to
    :func:`apply_augmentation_device`."""
    generator = None
    seed = noise_seed(seed, rank)

    def loss_fn(net, batch):
        nonlocal generator
        if "aug_mat0" not in batch:
            return base_loss(net, batch)
        if generator is None:
            generator = torch.Generator(device=batch["aug_mat0"].device).manual_seed(seed)
        with torch.no_grad():
            out = apply_augmentation_device(
                batch, generator, crop_h, crop_w, mean_window=mean_window, mean_per_pixel=mean_per_pixel,
                sample_dtype=sample_dtype,
            )
        extra = {k: out.pop(k) for k in BATCH_MEAN_KEYS if k in out}
        aug = {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
        if "frozen" in batch:
            aug["frozen"] = batch["frozen"]
        loss, aux = base_loss(net, aug)
        return loss, {**aux, **extra}

    return loss_fn
