"""The port's training augmentation against the JAX package, on the CPU:
the host sampler, the device transforms, the running mean and its files,
the augmented objectives and the Lpq episode schedule.

Every input is numpy from a seed, handed to both packages; the port's
transforms take NCHW, the JAX ones NHWC, and the tests permute at the
boundary. The JAX spatial sample runs its "exact" gather path, the port's
runs the warp's plain version (on the card, the kernel K1). Tolerances:
the sampler's arrays equal (==); the spatial sample 2e-6 on [0, 1] images
(the position flow's round trip x + (xpos - x) can move a sample by one
float32 ulp); the flow transform bit-equal, NaN pattern included; pixel
transforms 1e-6; an augmented batch (noise 0) 1e-3 on the 0-255 scale and
its flow bit-equal; losses rtol 1e-4 and gradients 1e-3 relative L2 as a
whole. The port's noise comes from a ``torch.Generator`` and cannot equal
``jax.random.normal``'s draws: it is held by its statistics.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params, unflatten_params
from flownet2_tpu.data import aug_params as jax_aug_params
from flownet2_tpu.data import augment_pipeline as jax_pipeline
from flownet2_tpu.data import mean as jax_mean
from flownet2_tpu.ops import augment as jax_aug
from flownet2_tpu.ops import losses as jax_losses
from flownet2_tpu.ops import mean as jax_ops_mean
from flownet2_tpu.tools import writers as jax_writers
from flownet2_tpu.train import objectives as jax_objectives
from flownet2_tpu.train.solver import Solver as JaxSolver
from flownet2_tpu.train.solvers import SolverConfig as JaxSolverConfig
from flownet2_tpu_torch.checkpoint import init_params, load_into, params_from_state_dict
from flownet2_tpu_torch.core.flow_io import read_ppm
from flownet2_tpu_torch.data import aug_params, augment_pipeline, mean
from flownet2_tpu_torch.models import FlowNetC, FlowNetSD
from flownet2_tpu_torch.ops import augment
from flownet2_tpu_torch.ops import mean as ops_mean
from flownet2_tpu_torch.ops.losses import LpqSchedule
from flownet2_tpu_torch.tools import writers
from flownet2_tpu_torch.train import Solver, SolverConfig, objectives

torch.set_num_threads(2)  # the suite runs several workers side by side

SRC_H, SRC_W, CROP_H, CROP_W = 96, 128, 64, 64


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


SPEC = augment.SpatialAugSpec(
    translate=augment.RandomSpec("uniform", mean=0.0, spread=0.3),
    rotate=augment.RandomSpec("uniform", mean=0.0, spread=0.5),
    zoom=augment.RandomSpec("uniform", exp=True, mean=0.1, spread=0.4),
    squeeze=augment.RandomSpec("uniform", exp=True, mean=0.0, spread=0.2),
)


def jax_spec(spec):
    """The same spec as the JAX package's dataclasses (field for field)."""
    fields = {k: None if v is None else jax_aug.RandomSpec(**vars(v)) for k, v in vars(spec).items()}
    return {
        augment.SpatialAugSpec: jax_aug.SpatialAugSpec,
        augment.ChromaticAugSpec: jax_aug.ChromaticAugSpec,
        augment.EffectAugSpec: jax_aug.EffectAugSpec,
        augment.ChromaticEigenAugSpec: jax_aug.ChromaticEigenAugSpec,
    }[type(spec)](**fields)


def sample_mats(seed, n, crop_h=CROP_H, crop_w=CROP_W, src_h=SRC_H, src_w=SRC_W):
    rng = np.random.default_rng(seed)
    coeffs = augment.sample_valid_spatial_coeffs_batch(
        SPEC, rng, n_items=n, crop_w=crop_w, crop_h=crop_h, src_w=src_w, src_h=src_h
    )
    return np.stack([augment.spatial_matrix(augment.SpatialCoeffs(*map(float, c)), crop_w, crop_h, src_w, src_h)
                     for c in coeffs])


# -- the host sampler: equal arrays from one seeded generator ------------------------------


RAND_SPECS = [
    dict(rand_type="uniform", mean=0.1, spread=0.4, exp=True),
    dict(rand_type="gaussian", mean=0.0, spread=0.3, discretize=True, multiplier=2.0),
    dict(rand_type="bernoulli", prob=0.4),
    dict(rand_type="uniform_bernoulli", mean=0.0, spread=0.4, prob=0.5),
    dict(rand_type="gaussian_bernoulli", mean=0.0, spread=0.03, prob=0.7, exp=True),
]


@pytest.mark.parametrize("kw", RAND_SPECS, ids=lambda kw: kw["rand_type"])
def test_random_spec_draws_match_jax(kw):
    ours, theirs = augment.RandomSpec(**kw), jax_aug.RandomSpec(**kw)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    assert [ours.sample(a, 0.7) for _ in range(20)] == [theirs.sample(b, 0.7) for _ in range(20)]
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(augment._sample_spec_n(ours, a, 50, 0.7), jax_aug._sample_spec_n(theirs, b, 50, 0.7))
    sched = dict(half_life=50000, initial_coeff=0.5, final_coeff=1.0)
    for it in (0, 1000, 123456):
        assert augment.CoeffSchedule(**sched).at(it) == jax_aug.CoeffSchedule(**sched).at(it)


@pytest.mark.parametrize("mirror", [0.0, 1.0])
def test_spatial_matrix_invert_and_crop_fits_match_jax(mirror):
    kw = dict(mirror=mirror, dx=0.1, dy=-0.05, angle=0.3, zoom_x=1.2, zoom_y=0.9)
    ours, theirs = augment.SpatialCoeffs(**kw), jax_aug.SpatialCoeffs(**kw)
    m = augment.spatial_matrix(ours, CROP_W, CROP_H, SRC_W, SRC_H)
    np.testing.assert_array_equal(m, jax_aug.spatial_matrix(theirs, CROP_W, CROP_H, SRC_W, SRC_H))
    np.testing.assert_array_equal(augment.invert_affine(m), jax_aug.invert_affine(m))
    for src in ((SRC_W, SRC_H), (70, 70)):
        assert augment.crop_fits(ours, CROP_W, CROP_H, *src) == jax_aug.crop_fits(theirs, CROP_W, CROP_H, *src)


def test_scalar_rejection_sampler_matches_jax():
    geo = dict(crop_w=CROP_W, crop_h=CROP_H, src_w=SRC_W, src_h=SRC_H)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(10):
        ours = augment.sample_valid_spatial_coeffs(SPEC, a, discount=0.8, **geo)
        theirs = jax_aug.sample_valid_spatial_coeffs(jax_spec(SPEC), b, discount=0.8, **geo)
        assert vars(ours) == vars(theirs)


@pytest.mark.parametrize("with_base", [False, True])
def test_batch_rejection_sampler_matches_jax(with_base):
    geo = dict(crop_w=CROP_W, crop_h=CROP_H, src_w=SRC_W, src_h=SRC_H, n_items=16, discount=0.9)
    base = np.tile(np.float32([0, 0.05, 0, 0.1, 1.1, 1.0]), (16, 1)) if with_base else None
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    ours = augment.sample_valid_spatial_coeffs_batch(SPEC, a, base=base, **geo)
    theirs = jax_aug.sample_valid_spatial_coeffs_batch(jax_spec(SPEC), b, base=base, **geo)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_sample_aug_arrays_match_jax():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    ours = augment_pipeline.sample_aug_arrays(augment_pipeline.FlowNetAugConfig(), a, 8, 384, 512, 320, 448, 0.8)
    theirs = jax_pipeline.sample_aug_arrays(jax_pipeline.FlowNetAugConfig(), b, 8, 384, 512, 320, 448, 0.8)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    batch = {"img0": np.zeros((3, SRC_H, SRC_W, 3), np.uint8)}
    out = augment_pipeline.make_flownet_augmenter(CROP_H, CROP_W)(batch, np.random.default_rng(8))
    ref = jax_pipeline.make_flownet_augmenter(CROP_H, CROP_W)(batch, np.random.default_rng(8))
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _bundles():
    r = augment.RandomSpec
    spatial = augment.SpatialAugSpec(translate=r("uniform", spread=0.2), rotate=r("gaussian", spread=0.1))
    chromatic = augment.ChromaticAugSpec(gamma=r("gaussian", exp=True, spread=0.02), color=r("uniform", exp=True, spread=0.1))
    eigen = augment.ChromaticEigenAugSpec(ladd_pow=r("gaussian", exp=True, spread=0.1), col_rotate=r("uniform", spread=0.5),
                                          sat_mult=r("uniform", exp=True, spread=0.2))
    effect = augment.EffectAugSpec(noise=r("uniform", mean=0.03, spread=0.03), shadow_angle=r("uniform", spread=3.0))
    ours = aug_params.AugSpecBundle(spatial=spatial, chromatic=chromatic, eigen=eigen, effect=effect)
    theirs = jax_aug_params.AugSpecBundle(spatial=jax_spec(spatial), chromatic=jax_spec(chromatic),
                                          eigen=jax_spec(eigen), effect=jax_spec(effect))
    return ours, theirs


@pytest.mark.parametrize("mode", ["add", "replace", "regenerate"])
def test_generate_augmentation_parameters_match_jax(mode):
    ours, theirs = _bundles()
    incoming = np.random.default_rng(9).normal(0, 0.05, (4, aug_params.NUM_COEFFS)).astype(np.float32)
    geo = dict(crop_w=CROP_W, crop_h=CROP_H, src_w=SRC_W, src_h=SRC_H)
    a, b = np.random.default_rng(10), np.random.default_rng(10)
    one = aug_params.generate_augmentation_parameters(ours, incoming[0], mode=mode, rng=a, **geo)
    ref = jax_aug_params.generate_augmentation_parameters(theirs, incoming[0], mode=mode, rng=b, **geo)
    np.testing.assert_array_equal(one, ref)
    many = aug_params.generate_augmentation_parameters_batch(ours, incoming, 4, mode=mode, rng=a, **geo)
    ref = jax_aug_params.generate_augmentation_parameters_batch(theirs, incoming, 4, mode=mode, rng=b, **geo)
    np.testing.assert_array_equal(many, ref)
    c = aug_params.array_to_coeffs(many[1])
    np.testing.assert_allclose(aug_params.coeffs_to_array(c), many[1], rtol=1e-6, atol=1e-7)


# -- the device transforms ---------------------------------------------------------------------


SPATIAL_CASES = {
    "96x128 to 64x64": (SRC_H, SRC_W, CROP_H, CROP_W),
    "crop wider than the source": (48, 64, 40, 96),
    "crop taller and wider": (40, 48, 56, 72),
}


@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_spatial_transform_matches_jax_exact(case):
    src_h, src_w, crop_h, crop_w = SPATIAL_CASES[case]
    rng = np.random.default_rng(11)
    mats = sample_mats(12, 3, crop_h, crop_w, src_h, src_w)
    if case != "96x128 to 64x64":  # no crop fits: rotate and zoom out, so positions clamp on every side
        mats = np.stack([augment.spatial_matrix(augment.SpatialCoeffs(angle=a, zoom_x=z, zoom_y=z), crop_w, crop_h,
                                                src_w, src_h) for a, z in ((0.2, 0.7), (-0.4, 1.3), (0.0, 1.0))])
    imgs = rng.uniform(0, 1, (3, src_h, src_w, 3)).astype(np.float32)
    got = augment.apply_spatial_transform(nchw(imgs), t(mats), crop_h, crop_w)
    ref = np.asarray(jax_aug.apply_spatial_transform(jnp.asarray(imgs), jnp.asarray(mats), crop_h, crop_w,
                                                     method="exact"))
    assert got.shape == (3, 3, crop_h, crop_w) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("nan_case", ["u channel invalid", "invalid block"])
def test_flow_augmentation_bit_equal_to_jax(nan_case):
    rng = np.random.default_rng(13)
    mats0, mats1 = sample_mats(14, 2), sample_mats(15, 2)
    inv1 = np.stack([augment.invert_affine(m) for m in mats1])
    flows = rng.uniform(-30, 30, (2, SRC_H, SRC_W, 2)).astype(np.float32)
    if nan_case == "u channel invalid":  # every crop placement samples NaN in u
        flows[0, :, :, 0] = np.nan
    else:
        flows[1, 10:60, 30:90, :] = np.nan
    got = nhwc(augment.apply_flow_augmentation(nchw(flows), t(mats0), t(inv1), CROP_H, CROP_W))
    ref = np.asarray(jax_aug.apply_flow_augmentation(jnp.asarray(flows), jnp.asarray(mats0), jnp.asarray(inv1),
                                                     CROP_H, CROP_W, method="exact"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).any() and not np.isnan(got).all()
    np.testing.assert_array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])


def _chromatic_coeffs(rng, n):
    return dict(gamma=rng.uniform(0.8, 1.2, n), brightness=rng.uniform(-0.1, 0.1, n),
                contrast=rng.uniform(0.7, 1.3, n), color=rng.uniform(0.8, 1.2, (n, 3)))


def _eigen_coeffs(rng, n):
    d = {k: rng.uniform(0.7, 1.3, (n, 3)) for k in ("pow_nomean", "mult_nomean", "pow_withmean", "mult_withmean")}
    d.update({k: rng.uniform(-0.1, 0.1, (n, 3)) for k in ("add_nomean", "add_withmean")})
    d.update(lmult_pow=rng.uniform(0.8, 1.2, n), lmult_add=rng.uniform(-0.1, 0.1, n),
             lmult_mult=rng.uniform(0.8, 1.2, n), col_angle=rng.uniform(-0.5, 0.5, n))
    return d


@pytest.mark.parametrize("transform", ["chromatic", "eigen", "shadow", "black"])
def test_pixel_transforms_match_jax(transform):
    rng = np.random.default_rng(16)
    n = 3
    # pixel values on a 1/256 grid, as 8-bit frames are: every channel sum of
    # the eigen transform's batch mean is then exact in float32 in any order.
    # On arbitrary floats XLA's mean is off by up to 5e-7 where torch's is
    # correctly rounded, and the transform's normalization amplifies that 4x.
    imgs = (rng.integers(0, 257, (n, 24, 32, 3)) / 256).astype(np.float32)

    def f32(d):
        return {k: np.asarray(v, np.float32) for k, v in d.items()}

    if transform == "chromatic":
        c = f32(_chromatic_coeffs(rng, n))
        got = nhwc(augment.apply_chromatic_transform(nchw(imgs), *(t(c[k]) for k in c)))
        ref = jax_aug.apply_chromatic_transform(jnp.asarray(imgs), *(jnp.asarray(c[k]) for k in c))
    elif transform == "eigen":
        c = f32(_eigen_coeffs(rng, n))
        got = nhwc(augment.apply_chromatic_eigen_transform(nchw(imgs), {k: t(v) for k, v in c.items()}))
        ref = jax_aug.apply_chromatic_eigen_transform(jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in c.items()})
    elif transform == "shadow":
        ang = rng.uniform(-3, 3, n)
        c = f32(dict(nx=np.cos(ang), ny=np.sin(ang), d=rng.uniform(-5, 5, n), s=rng.uniform(0.1, 0.5, n)))
        got = nhwc(augment.apply_shadow(nchw(imgs), *(t(c[k]) for k in c)))
        ref = jax_aug.apply_shadow(jnp.asarray(imgs), *(jnp.asarray(c[k]) for k in c))
    else:
        flows = rng.normal(0, 3, (n, 24, 32, 2)).astype(np.float32)
        flows[0, 3:6, 4:9] = np.nan
        c = f32(dict(black=[0.0, 1.0, 0.0], frac=[0.1, 0.2, 0.0]))
        gi, gf = augment.apply_black_augmentation(nchw(imgs), nchw(flows), t(c["black"]), t(c["frac"]))
        ri, rf = jax_aug.apply_black_augmentation(jnp.asarray(imgs), jnp.asarray(flows), jnp.asarray(c["black"]),
                                                  jnp.asarray(c["frac"]))
        np.testing.assert_array_equal(np.isnan(nhwc(gf)), np.isnan(np.asarray(rf)))
        np.testing.assert_allclose(nhwc(gf), np.asarray(rf), atol=1e-6, rtol=0)
        got, ref = nhwc(gi), ri
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("operation", ["subtract", "add"])
@pytest.mark.parametrize("by", ["values", "array"])
def test_apply_mean_matches_jax(operation, by):
    rng = np.random.default_rng(17)
    x = rng.uniform(0, 255, (2, 8, 10, 3)).astype(np.float32)
    scales = dict(operation=operation, input_scale=0.5, mean_scale=2.0, output_scale=1 / 255)
    if by == "values":
        got = ops_mean.apply_mean(nchw(x), mean_values=[104.0, 117.0, 123.0], **scales)
        ref = jax_ops_mean.apply_mean(jnp.asarray(x), mean_values=[104.0, 117.0, 123.0], **scales)
    else:
        m = rng.uniform(0, 255, (8, 10, 3)).astype(np.float32)
        got = ops_mean.apply_mean(nchw(x), mean_array=t(m.transpose(2, 0, 1).copy()), **scales)
        ref = jax_ops_mean.apply_mean(jnp.asarray(x), mean_array=jnp.asarray(m), **scales)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        ops_mean.apply_mean(nchw(x))


def test_gaussian_noise_statistics_and_generator():
    grey = torch.full((8, 3, 64, 64), 0.5)
    std = torch.full((8,), 0.05)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    assert torch.equal(augment.apply_gaussian_noise(grey, torch.zeros(8), gen(0)), grey)
    a = augment.apply_gaussian_noise(grey, std, gen(1))
    assert torch.equal(a, augment.apply_gaussian_noise(grey, std, gen(1)))
    assert not torch.equal(a, augment.apply_gaussian_noise(grey, std, gen(2)))
    assert abs((a - grey).std().item() / 0.05 - 1) < 0.03
    loud = augment.apply_gaussian_noise(grey, torch.full((8,), 1.0), gen(3))
    assert loud.min().item() == 0.0 and loud.max().item() == 1.0


# -- the running mean and its files --------------------------------------------------------


@pytest.mark.parametrize("per_pixel", [False, True])
def test_running_mean_and_mirror_match_jax_over_five_iterations(per_pixel):
    rng = np.random.default_rng(18)
    ours = mean.MeanRecompute(6, 8, 3, window=3, per_pixel=per_pixel)
    theirs = jax_mean.MeanRecompute(6, 8, 3, window=3, per_pixel=per_pixel)
    for _ in range(5):
        imgs = rng.uniform(0, 1, (4, 6, 8, 3)).astype(np.float32)
        b, rb = ours.attach({}), theirs.attach({})
        got, bm = mean.recompute_mean_and_subtract(nchw(imgs), t(b["mean_image0"]), t(b["mean_iter"]),
                                                   window=3, per_pixel=per_pixel)
        ref, rbm = jax_mean.recompute_mean_and_subtract(jnp.asarray(imgs), jnp.asarray(rb["mean_image0"]),
                                                        jnp.asarray(rb["mean_iter"]), window=3, per_pixel=per_pixel)
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-6, rtol=0)
        np.testing.assert_allclose(bm.numpy(), np.asarray(rbm), atol=1e-6, rtol=0)
        ours.update(bm.numpy())
        theirs.update(np.asarray(rbm))
        np.testing.assert_allclose(ours.mean, theirs.mean, atol=1e-6, rtol=0)
    assert ours.num_iter == theirs.num_iter == 5
    got = mean.subtract_fixed_mean(nchw(imgs), [0.4, 0.5, 0.6])
    np.testing.assert_allclose(nhwc(got), np.asarray(jax_mean.subtract_fixed_mean(jnp.asarray(imgs), [0.4, 0.5, 0.6])),
                               atol=1e-6, rtol=0)


def test_mean_files_interchange_with_jax(tmp_path):
    rng = np.random.default_rng(19)
    ours = mean.MeanRecompute(5, 7, 3, window=4)
    ours.update(rng.uniform(0, 1, (5, 7, 3)))
    path = ours.write_mean(str(tmp_path / "ours" / "mean0.float3"))
    np.testing.assert_array_equal(jax_writers.read_float_blob(path), ours.mean)
    assert os.path.exists(tmp_path / "ours" / "mean0.ppm")
    theirs = jax_mean.MeanRecompute(5, 7, 3, window=4)
    theirs.update(rng.uniform(0, 1, (5, 7, 3)))
    ref = theirs.write_mean(str(tmp_path / "theirs" / "mean0.float3"))
    loaded = mean.MeanRecompute.from_mean_file(ref, window=0)
    np.testing.assert_array_equal(loaded.mean, theirs.mean)
    assert loaded.num_iter == 1 and loaded.per_pixel
    for name in ("mean0.float3", "mean0.ppm"):  # the two writers give the same bytes
        ours.mean = theirs.mean
        ours.write_mean(str(tmp_path / "ours" / "mean0.float3"))
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
    blob = rng.normal(0, 1, (2, 3, 4)).astype(np.float32)
    writers._write_float_blob(str(tmp_path / "b.float3"), blob)
    np.testing.assert_array_equal(writers.read_float_blob(str(tmp_path / "b.float3")), blob)


# -- the augmented batch and the augmented objectives -----------------------------------------


def source_batch(seed, n=2, h=SRC_H, w=SRC_W, transport=False):
    """A host batch at source resolution with its sampled arrays (noise 0)."""
    from flownet2_tpu_torch.core.codec import encode_flow_int16

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = [np.clip(127.5 + 60 * np.sin(xs[..., None] * rng.uniform(0.02, 0.08, 3) + ys[..., None]
                                        * rng.uniform(0.02, 0.08, 3) + rng.uniform(0, 6, 3)), 0, 255)
            for _ in range(2 * n)]
    batch = {"img0": np.stack(imgs[:n]).astype(np.uint8), "img1": np.stack(imgs[n:]).astype(np.uint8),
             "flow": rng.normal(0, 4, (n, h, w, 2)).astype(np.float32)}
    batch["flow"][0, 20:40, 30:60] = np.nan
    if transport:
        batch["flow"] = encode_flow_int16(batch["flow"])
    else:
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch.update(augment_pipeline.sample_aug_arrays(augment_pipeline.FlowNetAugConfig(), rng, n, h, w, 64, 128))
    batch["aug_noise"] = np.zeros(n, np.float32)
    return batch


@pytest.mark.parametrize("transport", [False, True], ids=["float", "transport"])
def test_augmentation_device_matches_jax(transport):
    batch = source_batch(20, transport=transport)
    gen = torch.Generator().manual_seed(0)
    got = augment_pipeline.apply_augmentation_device({k: t(v) for k, v in batch.items()}, gen, 64, 128)
    ref = jax_pipeline.apply_augmentation_device({k: jnp.asarray(v) for k, v in batch.items()},
                                                 jax.random.PRNGKey(0), 64, 128, spatial_method="exact")
    for k in ("img0", "img1"):
        assert got[k].shape == (2, 3, 64, 128) and got[k].dtype == torch.float32
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(ref[k]), atol=1e-3, rtol=0)
    flow, ref_flow = nhwc(got["flow"]), np.asarray(ref["flow"])
    np.testing.assert_array_equal(np.isnan(flow), np.isnan(ref_flow))
    assert np.isnan(flow).any()
    np.testing.assert_array_equal(flow[~np.isnan(flow)], ref_flow[~np.isnan(ref_flow)])


def _grads_as_whole(grads: dict, ref: dict) -> float:
    diff = sum(float(np.sum((np.asarray(grads[k]) - np.asarray(r)) ** 2)) for k, r in ref.items())
    return (diff / sum(float(np.sum(np.asarray(r) ** 2)) for r in ref.values())) ** 0.5


@pytest.mark.parametrize("recompute_mean", [False, True], ids=["no mean", "running mean"])
def test_augmented_flownet_c_loss_and_gradients_match_jax(recompute_mean):
    flat = init_params("flownetc", seed=2)
    batch = source_batch(21)
    if recompute_mean:
        batch = mean.MeanRecompute(64, 128, window=4).attach(batch, key="mean_image0")
    ours = augment_pipeline.make_augmented_loss(objectives.flownet_c_loss, 64, 128, seed=3, mean_window=4)
    theirs = jax_pipeline.make_augmented_loss(jax_objectives.flownet_c_loss, 64, 128, seed=3, mean_window=4,
                                              spatial_method="exact")
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(theirs, has_aux=True))(
        unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.device("meta"):
        net = FlowNetC()
    load_into(net, flat)
    loss, aux = ours(net, {k: t(v) for k, v in batch.items()})
    loss.backward()
    grads = params_from_state_dict({k: p.grad for k, p in net.named_parameters()})
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert _grads_as_whole(grads, flatten_params(ref_grads)) <= 1e-3
    assert ("aug_batch_mean0" in aux) == recompute_mean == ("aug_batch_mean0" in ref_aux)
    if recompute_mean:
        np.testing.assert_allclose(aux["aug_batch_mean0"].numpy(), np.asarray(ref_aux["aug_batch_mean0"]),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("episode", [(2.0, 0.5), (1.0, 1.0)])
def test_sdhom_loss_with_black_mask_matches_jax(episode):
    flat = init_params("flownet2-sd", seed=4)
    rng = np.random.default_rng(22)
    batch = {k: v[:, :64, :128] for k, v in source_batch(23).items() if k in ("img0", "img1", "flow")}
    batch.update(black_mask=np.asarray([0.0, 1.0], np.float32), border_frac=np.asarray([0.15, 0.0], np.float32))
    batch["flow"] = batch["flow"] + rng.normal(0, 1, batch["flow"].shape).astype(np.float32)
    jax_loss = jax.jit(functools.partial(jax_objectives.LOSSES["flownet2-sd-sdhom"], episode=episode))
    ref, _ = jax_loss(unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.device("meta"):
        net = FlowNetSD()
    load_into(net, flat)
    with torch.no_grad():
        got, aux = objectives.LOSSES["flownet2-sd-sdhom"](net, {k: t(v) for k, v in batch.items()}, episode=episode)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    assert set(aux) == {"loss", "flow6", "flow5", "flow4", "flow3", "flow2"}


def test_solver_loss_schedule_switches_with_jax():
    """The episode each iteration's loss sees, port against JAX, on a toy loss."""
    kw = dict(start_iters=(0, 2, 5), ps=(1.0, 2.0, 2.0), qs=(1.0, 0.5, 1.0))
    seen, jax_seen = [], []

    def loss_fn(net, batch, episode=(9.0, 9.0)):
        seen.append(episode)
        loss = net(batch["x"]).abs().sum() ** episode[1]
        return loss, {"loss": loss}

    def jax_loss(params, batch, episode=(9.0, 9.0)):
        jax_seen.append(episode)
        loss = jnp.sum(jnp.abs(params["w"] * batch["x"])) ** episode[1]
        return loss, {"loss": loss}

    solver = Solver(SolverConfig(solver_type="sgd", base_lr=0.01, max_iter=7), loss_fn, torch.nn.Linear(3, 1),
                    device="cpu", loss_schedule=LpqSchedule(**kw))
    jax_solver = JaxSolver(JaxSolverConfig(solver_type="sgd", base_lr=0.01, max_iter=7), jax_loss,
                           {"w": jnp.ones((3,))}, loss_schedule=jax_losses.LpqSchedule(**kw), display=0, jit_step=False)
    episodes, jax_episodes = [], []
    for _ in range(7):
        solver.step({"x": np.ones((1, 3), np.float32)})
        episodes.append(seen[-1])
        jax_solver.step({"x": jnp.ones((3,))})
        jax_episodes.append(jax_seen[-1])
    assert episodes == jax_episodes == [(1.0, 1.0)] * 2 + [(2.0, 0.5)] * 3 + [(2.0, 1.0)] * 2


def test_write_augmented_matches_jax_names_and_log(tmp_path):
    batch = source_batch(24)
    logs, jax_logs = [], []
    paths = augment_pipeline.write_augmented(batch, str(tmp_path / "ours"), 7, 64, 128, log=logs.append)
    ref = jax_pipeline.write_augmented(batch, str(tmp_path / "theirs"), 7, 64, 128, log=jax_logs.append)
    assert logs == jax_logs and len(logs) == 2
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref] == [
        "aug0_0000007(000).ppm", "aug0_0000007(001).ppm", "aug1_0000007(000).ppm", "aug1_0000007(001).ppm"]
    for p, r in zip(paths, ref):  # noise 0: the same pixels but where a value sits at a rounding edge
        assert np.abs(read_ppm(p).astype(int) - read_ppm(r).astype(int)).max() <= 1


def test_augmented_loss_noise_stream_advances_and_repeats_per_seed():
    """The noise generator is seeded once: a second call on the same batch
    draws other noise, and a fresh wrapper with the same seed draws the
    first call's noise again."""
    batch = {k: t(v) for k, v in source_batch(26).items()}
    batch["aug_noise"] = torch.full_like(batch["aug_noise"], 0.05)

    def draws(seed, n):
        seen = []

        def base(net, b):
            seen.append(b["img0"])
            return b["img0"].sum(), {}

        wrapped = augment_pipeline.make_augmented_loss(base, 64, 128, seed)
        for _ in range(n):
            wrapped(None, batch)
        return seen

    first, second = draws(5, 2)
    assert not torch.equal(first, second)
    assert torch.equal(first, draws(5, 1)[0])
    assert not torch.equal(first, draws(6, 1)[0])


def test_augmentation_records_no_gradient_and_passes_batches_through():
    """The augmentation runs under no_grad (an image that requires a
    gradient gives augmented images that do not), hands the base loss NHWC
    crops and ``frozen``, and passes a batch without aug_* arrays as is."""
    batch = {k: t(v) for k, v in source_batch(25).items()}
    batch["img0"].requires_grad_(True)
    seen = {}

    def base(net, b):
        seen.update(b)
        return b["img0"].sum(), {"loss": b["img0"].sum()}

    wrapped = augment_pipeline.make_augmented_loss(base, 64, 128)
    wrapped(None, {**batch, "frozen": "upstream"})
    assert set(seen) == {"img0", "img1", "flow", "frozen"} and seen["frozen"] == "upstream"
    assert seen["img0"].shape == (2, 64, 128, 3) and not seen["img0"].requires_grad
    plain = {k: batch[k] for k in ("img0", "img1", "flow")}
    seen.clear()
    wrapped(None, plain)
    assert seen["img0"] is plain["img0"]  # no aug_* arrays: passed through as is
