"""The PyTorch port's operators against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays. The port's ops take NCHW; the JAX ops NHWC, so the tests permute at
the boundary. On CPU tensors the port runs its plain PyTorch versions (the
CUDA kernels are held against those on the card in test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.models.import_caffe import CaffeBlob, convert_conv_blob
from flownet2_tpu.ops.activations import leaky_relu as jax_leaky_relu
from flownet2_tpu.ops.channel_norm import channel_norm as jax_channel_norm
from flownet2_tpu.ops.conv import conv2d as jax_conv2d
from flownet2_tpu.ops.conv import deconv2d_ps as jax_deconv2d_ps
from flownet2_tpu.ops.correlation import correlation as jax_correlation
from flownet2_tpu.ops.correlation import correlation_1d as jax_correlation_1d
from flownet2_tpu.ops.correlation import correlation_1d_auto, correlation_auto
from flownet2_tpu.ops.pallas.warp import flow_warp_pallas
from flownet2_tpu.ops.resample import resample as jax_resample
from flownet2_tpu.ops.warp import flow_warp_gather
from flownet2_tpu_torch import checkpoint
from flownet2_tpu_torch.models.common import conv, deconv
from flownet2_tpu_torch.ops.activations import leaky_relu
from flownet2_tpu_torch.ops.channel_norm import channel_norm
from flownet2_tpu_torch.ops.correlation import (
    correlation,
    correlation_1d,
    correlation_1d_backward_cuda,
    correlation_1d_backward_plain,
    correlation_1d_cuda,
    correlation_1d_output_shape,
    correlation_1d_plain,
    correlation_backward_cuda,
    correlation_backward_plain,
    correlation_plain,
)
from flownet2_tpu_torch.ops.resample import resample
from flownet2_tpu_torch.ops.warp import flow_warp, flow_warp_backward_cuda, flow_warp_backward_plain, flow_warp_plain
from oracles import correlation_oracle, flow_warp_oracle

torch.set_num_threads(2)  # the suite runs several workers side by side


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _warp_inputs(rng, n=2, h=24, w=40, c=3, flow_scale=30.0):
    img = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-flow_scale, flow_scale, (n, h, w, 2)).astype(np.float32)
    flow[:, :3, :3, 0] = 500.0  # far out of range
    flow[:, 5, :, 0] = w - 1 - np.arange(w) + 0.5  # lands in (W-1, W): valid, right clamp
    flow[:, 6, :, 1] = -6.0 - 1e-3  # one row above the top: invalid
    flow[:, 7, :4, :] = np.nan
    return img, flow


# The geometries on which the CUDA kernels split a row into 4-pixel vector
# runs, row tails and the scalar path (tests/test_torch_gpu.py holds them to
# the plain version on the card): (C, H, W, storage offset of the port's
# inputs). (3, 24, 40, 0) is _warp_inputs' own geometry.
WARP_GEOMETRIES = [(3, 24, 40, 0), (1, 2, 2, 0), (5, 2, 5, 1), (3, 9, 5, 0), (1, 9, 130, 1), (3, 9, 130, 0),
                   (5, 9, 448, 0), (3, 2, 448, 1)]
WARP_GEOMETRY_IDS = [f"c{c}-{h}x{w}{'-offset1' if off else ''}" for c, h, w, off in WARP_GEOMETRIES]


def _warp_edge_inputs(rng, c, h, w, n=2):
    """Image and flow (NHWC) at any geometry: random flows up to 0.6 *
    max(H, W) px, and per pixel, in turn, flows that land inside (W-1, W),
    just below 0, at +inf, at y2 = -inf and inside (H-1, H); no exact tie
    of the clip (x2 = 0 or W-1), where jnp.clip's derivative differs from
    PyTorch's. Returns (img, flow, the (N, H, W) case of each pixel)."""
    img = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-1, 1, (n, h, w, 2)).astype(np.float32) * max(h, w) * 0.6
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    case = (np.arange(h * w).reshape(h, w) + 3 * np.arange(n)[:, None, None]) % 7
    u, v = flow[..., 0], flow[..., 1]
    for k, target, value in ((1, u, w - 1 - xs + 0.5), (2, u, -xs - 0.25), (5, v, h - 1 - ys + 0.5)):
        target[case == k] = np.broadcast_to(value, case.shape)[case == k]
    u[case == 3], v[case == 4] = np.inf, -np.inf
    return img, flow, case


def _warp_geometry_inputs(rng, c, h, w):
    """_warp_inputs at its own geometry, else _warp_edge_inputs; and the
    mask of pixels whose target lies inside (W-1, W)."""
    if (c, h, w) == (3, 24, 40):
        img, flow = _warp_inputs(rng)
        saturated = np.zeros(flow.shape[:3], bool)
        saturated[:, 5] = True
        return img, flow, saturated
    img, flow, case = _warp_edge_inputs(rng, c, h, w)
    return img, flow, case == 1


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` as a contiguous tensor whose storage starts ``offset`` elements earlier."""
    if not offset:
        return t
    out = torch.empty(t.numel() + offset, dtype=t.dtype)[offset:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.storage_offset() == offset
    return out


# -- FlowWarp ---------------------------------------------------------------


@pytest.mark.parametrize("fill", [0.0, float("nan")])
@pytest.mark.parametrize("c,h,w,offset", WARP_GEOMETRIES, ids=WARP_GEOMETRY_IDS)
def test_flow_warp_matches_jax_gather_and_oracle(rng, c, h, w, offset, fill):
    """atol 1e-5: both compute the same float32 lerps; NaN positions match."""
    img, flow, _ = _warp_geometry_inputs(rng, c, h, w)
    got = nhwc(flow_warp(_offset(nchw(img), offset), _offset(nchw(flow), offset), fill))
    ref = np.asarray(flow_warp_gather(jnp.asarray(img), jnp.asarray(flow), fill))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    flow_o = np.nan_to_num(flow, nan=1e6)  # the loop oracle cannot index NaN
    oracle = flow_warp_oracle(img, flow_o, fill)
    got_o = nhwc(flow_warp(_offset(nchw(img), offset), _offset(nchw(flow_o), offset), fill))
    np.testing.assert_allclose(got_o, oracle, atol=1e-5)


def test_flow_warp_matches_pallas_interpret_in_budget(rng):
    """Within the TPU kernel's window budget it is exact too (atol 1e-5),
    as tests/test_pallas.py checks it against the gather warp."""
    n, h, w, c = 2, 40, 300, 3
    img = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-6, 6, (n, h, w, 2)).astype(np.float32)
    flow[:, :4, :4, 0] = 500.0
    ref = np.asarray(flow_warp_pallas(jnp.asarray(img), jnp.asarray(flow), interpret=True))
    got = nhwc(flow_warp(nchw(img), nchw(flow)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_flow_warp_bf16_matches_jax_gather(rng):
    """bf16 image and flow: both lerp in float32 and round once, so they
    agree to one bf16 ulp of the output range (1/128 for values in [-1, 1])."""
    img, flow = _warp_inputs(rng)
    img_b = jnp.asarray(img, jnp.bfloat16)
    flow_b = jnp.asarray(flow, jnp.bfloat16)
    ref = np.asarray(flow_warp_gather(img_b, flow_b).astype(jnp.float32))
    got = flow_warp(nchw(img).bfloat16(), nchw(flow).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), ref, atol=2.0**-7)


def test_flow_warp_rejects_bad_shapes(rng):
    img = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError):
        flow_warp(img, torch.zeros(1, 2, 8, 7))
    with pytest.raises(ValueError):
        flow_warp_plain(torch.zeros(1, 3, 1, 8), torch.zeros(1, 2, 1, 8))


def test_flow_warp_cuda_wrapper_refuses_cpu_tensors():
    from flownet2_tpu_torch.ops.warp import flow_warp_cuda

    before = flow_warp_cuda.launches
    with pytest.raises(ValueError):
        flow_warp_cuda(torch.zeros(1, 3, 4, 4), torch.zeros(1, 2, 4, 4))
    assert flow_warp_cuda.launches == before


def _warp_vjp_jax(img, flow, g, fill):
    _, vjp = jax.vjp(lambda a, b: flow_warp_gather(a, b, fill), jnp.asarray(img), jnp.asarray(flow))
    return tuple(np.asarray(v) for v in vjp(jnp.asarray(g)))


def _warp_grads(img, flow, g, fill, offset=0):
    """The autograd route of flow_warp (NCHW) -> NHWC gradients, the
    inputs' storage starting ``offset`` elements earlier."""
    ti, tf = (_offset(nchw(a), offset).requires_grad_(True) for a in (img, flow))
    d_img, d_flow = torch.autograd.grad(flow_warp(ti, tf, fill), (ti, tf), _offset(nchw(g), offset))
    return nhwc(d_img), nhwc(d_flow)


@pytest.mark.parametrize("fill", [0.0, float("nan")])
@pytest.mark.parametrize("c,h,w,offset", WARP_GEOMETRIES, ids=WARP_GEOMETRY_IDS)
def test_flow_warp_backward_matches_jax_vjp(rng, c, h, w, offset, fill):
    """d_image and d_flow, with targets out of range and in the clamped last
    column, against jax.vjp of the gather warp: rtol/atol 1e-5. Both the
    autograd route and flow_warp_backward_plain."""
    img, flow, saturated = _warp_geometry_inputs(rng, c, h, w)
    flow[np.isnan(flow)] = 3.25  # no NaN flows here (see the next test)
    g = rng.standard_normal(img.shape).astype(np.float32)
    ref_img, ref_flow = _warp_vjp_jax(img, flow, g, fill)
    got_img, got_flow = _warp_grads(img, flow, g, fill, offset)
    plain_img, plain_flow = flow_warp_backward_plain(*(_offset(nchw(a), offset) for a in (img, flow, g)))
    for got, ref in ((got_img, ref_img), (got_flow, ref_flow), (nhwc(plain_img), ref_img),
                     (nhwc(plain_flow), ref_flow)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    least = 1 if (c, h, w) == (3, 24, 40) else 0  # some gradient passes (a 2x2 image has few valid taps)
    assert np.abs(ref_flow).max() > least and np.abs(ref_img).max() > least
    assert saturated.any() and not got_flow[..., 0][saturated].any()  # x2 in (W-1, W): the clip saturates


def test_flow_warp_backward_nan_flow_is_zero_and_finite(rng):
    """A NaN flow passes no gradient: 0, never NaN (JAX's gather VJP gives
    NaN there); elsewhere the gradients equal JAX's."""
    img, flow = _warp_inputs(rng)  # row 7 has NaN flows
    g = rng.standard_normal(img.shape).astype(np.float32)
    ref_img, ref_flow = _warp_vjp_jax(img, flow, g, 0.0)
    for fill in (0.0, float("nan")):
        got_img, got_flow = _warp_grads(img, flow, g, fill)
        assert np.isfinite(got_img).all() and np.isfinite(got_flow).all()
        assert not got_flow[:, 7, :4].any()
        ok = np.isfinite(ref_flow)
        np.testing.assert_allclose(got_flow[ok], ref_flow[ok], rtol=1e-5, atol=1e-5)
        ok = np.isfinite(ref_img)
        np.testing.assert_allclose(got_img[ok], ref_img[ok], rtol=1e-5, atol=1e-5)


def test_backward_cuda_wrappers_refuse_cpu_tensors():
    before = flow_warp_backward_cuda.launches, correlation_backward_cuda.launches
    z = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError):
        flow_warp_backward_cuda(z, torch.zeros(1, 2, 4, 4), z)
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        correlation_backward_cuda(f, f, torch.zeros(1, 9, 4, 4), max_displacement=1, stride2=1)
    assert (flow_warp_backward_cuda.launches, correlation_backward_cuda.launches) == before


# -- Correlation --------------------------------------------------------------


CORR_CASES = {
    "flownetc": dict(max_displacement=20, kernel_size=1, stride1=1, stride2=2, pad=20, multiply=True),
    "subtract_k3": dict(max_displacement=2, kernel_size=3, stride1=2, stride2=1, pad=3, multiply=False),
}


@pytest.mark.parametrize("case", sorted(CORR_CASES))
def test_correlation_matches_jax_and_oracle(rng, case):
    """rtol/atol 1e-5 (relative to max|ref|): float32 channel sums in
    another order."""
    kw = CORR_CASES[case]
    f1 = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    got = nhwc(correlation(nchw(f1), nchw(f2), **kw))
    ref = np.asarray(correlation_auto(jnp.asarray(f1), jnp.asarray(f2), **kw))
    oracle = correlation_oracle(f1, f2, **kw)
    assert got.shape == ref.shape == oracle.shape
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol)


@pytest.mark.parametrize("kw,shape", [
    (dict(max_displacement=4, stride2=2, pad=4), (2, 9, 11, 8)),
    (dict(max_displacement=20, stride2=2, pad=20), (2, 9, 11, 8)),
    (dict(max_displacement=4, stride2=1, pad=4), (2, 9, 11, 8)),
    (dict(max_displacement=20, stride2=2, pad=20), (1, 7, 19, 6)),
], ids=["md4", "flownetc", "md4-stride1", "flownetc-ragged-width"])
def test_correlation_backward_matches_jax_vjp(rng, kw, shape):
    """df1 and df2 against jax.vjp of correlation_auto (its hand-written
    VJP): atol 1e-5 of max|ref|. Both the autograd route and
    correlation_backward_plain; at stride2 2 and 1, and at a width of 19,
    which cuts the CUDA kernel's 4-column runs in both of its planes."""
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: correlation_auto(a, b, **kw), jnp.asarray(f1), jnp.asarray(f2))
    g = rng.standard_normal(out.shape).astype(np.float32)
    ref1, ref2 = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    a, b = nchw(f1).requires_grad_(True), nchw(f2).requires_grad_(True)
    got1, got2 = torch.autograd.grad(correlation(a, b, **kw), (a, b), nchw(g))
    plain1, plain2 = correlation_backward_plain(nchw(f1), nchw(f2), nchw(g), **kw)
    for got, ref in ((got1, ref1), (got2, ref2), (plain1, ref1), (plain2, ref2)):
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(nhwc(got), ref, rtol=1e-5, atol=tol)


def test_correlation_plain_matches_jax_at_sintel_like_geometry(rng):
    """correlation_plain against correlation_auto at a feature map shaped
    like Sintel's (wider than tall, W/H about 2.3: 1x32x14x32), FlowNetC's md
    20 / stride2 2, where most displacements leave the map: atol 1e-5 of
    max|ref|."""
    kw = CORR_CASES["flownetc"]
    f1 = rng.standard_normal((1, 14, 32, 32)).astype(np.float32)
    f2 = rng.standard_normal((1, 14, 32, 32)).astype(np.float32)
    got = nhwc(correlation_plain(nchw(f1), nchw(f2), **kw))
    ref = np.asarray(correlation_auto(jnp.asarray(f1), jnp.asarray(f2), **kw))
    assert got.shape == ref.shape == (1, 14, 32, 441)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_correlation_flownetc_channels_and_dtype(rng):
    f = torch.from_numpy(rng.standard_normal((1, 8, 6, 7)).astype(np.float32)).bfloat16()
    out = correlation_plain(f, f, **CORR_CASES["flownetc"])
    assert out.shape == (1, 441, 6, 7) and out.dtype == torch.bfloat16
    # zero displacement (the centre channel) of f with itself is the mean square
    centre = (f.float() ** 2).mean(dim=1)
    np.testing.assert_allclose(out[:, 220].float().numpy(), centre.numpy(), rtol=1e-2)


def test_correlation_rejects_even_kernel():
    with pytest.raises(ValueError):
        correlation(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8), max_displacement=1, kernel_size=2)


# -- 1-D (stereo) correlation ---------------------------------------------------


def _corr1d_inputs(rng, shape=(2, 5, 13, 6)):
    """Two NHWC feature maps; the default is 13 wide, narrower than DispNet's
    md 40, so most displacements leave the map."""
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("md", [4, 40])
@pytest.mark.parametrize("stride2", [1, 2])
@pytest.mark.parametrize("single_direction", [-1, 0, 1])
def test_correlation_1d_plain_matches_jax_fast_and_general(rng, single_direction, stride2, md):
    """DispNet's configuration (multiply, k 1, stride1 1, pad == md) on a
    13-wide map: correlation_1d_plain against correlation_1d_auto's fast
    path (the banded matmul) and against the general scan correlation_1d,
    atol 1e-5 of max|ref| (float32 channel sums in another order)."""
    kw = dict(max_displacement=md, kernel_size=1, stride1=1, stride2=stride2, pad=md,
              single_direction=single_direction)
    f1, f2 = _corr1d_inputs(rng)
    got = nhwc(correlation_1d(nchw(f1), nchw(f2), **kw))
    gw = (md // stride2) + 1 if single_direction else 2 * (md // stride2) + 1
    for jax_fn in (correlation_1d_auto, jax_correlation_1d):
        ref = np.asarray(jax_fn(jnp.asarray(f1), jnp.asarray(f2), **kw))
        assert got.shape == ref.shape == (2, 5, 13, gw)
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


CORR1D_GENERAL_CASES = {
    "k3-stride1-2": dict(max_displacement=4, kernel_size=3, stride1=2, stride2=1, pad=4, single_direction=0),
    "subtract": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=2, pad=2, single_direction=-1,
                     multiply=False),
    "k3-no-pad-right": dict(max_displacement=3, kernel_size=3, stride1=2, stride2=1, pad=0, single_direction=1),
}


@pytest.mark.parametrize("case", sorted(CORR1D_GENERAL_CASES))
def test_correlation_1d_plain_matches_jax_general_path(rng, case):
    """Configurations only the general scan takes (k 3 with stride1 2,
    subtract mode, no padding): correlation_1d_plain against
    correlation_1d_auto (which routes them to correlation_1d), atol 1e-5 of
    max|ref|; the output shape is correlation_1d_output_shape's."""
    kw = CORR1D_GENERAL_CASES[case]
    f1, f2 = _corr1d_inputs(rng, (2, 9, 17, 6))
    got = nhwc(correlation_1d_plain(nchw(f1), nchw(f2), **kw))
    ref = np.asarray(correlation_1d_auto(jnp.asarray(f1), jnp.asarray(f2), **kw))
    out_h, out_w, gw = correlation_1d_output_shape(9, 17, **{k: v for k, v in kw.items() if k != "multiply"})
    assert got.shape == ref.shape == (2, out_h, out_w, gw)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("single_direction,stride2,md,shape", [
    (-1, 1, 40, (2, 5, 13, 8)), (0, 2, 4, (2, 5, 13, 8)), (1, 1, 4, (1, 3, 19, 6)), (-1, 2, 4, (1, 3, 19, 6)),
], ids=["dispnet", "both-sides-stride2", "right", "left-stride2"])
def test_correlation_1d_backward_matches_jax_vjp(rng, single_direction, stride2, md, shape):
    """df1 and df2 against jax.vjp of correlation_1d_auto (its hand-written
    VJP, _corr1d_selmm_bwd), through autograd and through
    correlation_1d_backward_plain: atol 1e-5 of max|ref|."""
    kw = dict(max_displacement=md, kernel_size=1, stride1=1, stride2=stride2, pad=md,
              single_direction=single_direction)
    f1, f2 = _corr1d_inputs(rng, shape)
    out, vjp = jax.vjp(lambda a, b: correlation_1d_auto(a, b, **kw), jnp.asarray(f1), jnp.asarray(f2))
    g = rng.standard_normal(out.shape).astype(np.float32)
    ref1, ref2 = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    a, b = nchw(f1).requires_grad_(True), nchw(f2).requires_grad_(True)
    got1, got2 = torch.autograd.grad(correlation_1d(a, b, **kw), (a, b), nchw(g))
    plain1, plain2 = correlation_1d_backward_plain(nchw(f1), nchw(f2), nchw(g), **kw)
    for got, ref in ((got1, ref1), (got2, ref2), (plain1, ref1), (plain2, ref2)):
        np.testing.assert_allclose(nhwc(got), ref, atol=1e-5 * np.abs(ref).max())


def test_correlation_1d_dispnet_channels_and_dtype(rng):
    """bfloat16 in, bfloat16 out; with single_direction -1 the last of the
    41 channels is the zero displacement: f with itself gives the channel
    mean square there, and channel 0 (40 columns left) is 0 in the first 40
    columns, where the partner lies in the padding."""
    f = torch.from_numpy(rng.standard_normal((1, 8, 3, 50)).astype(np.float32)).bfloat16()
    out = correlation_1d_plain(f, f, max_displacement=40, pad=40, single_direction=-1)
    assert out.shape == (1, 41, 3, 50) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out[:, 40].float().numpy(), (f.float() ** 2).mean(dim=1).numpy(), rtol=1e-2)
    assert not out[:, 0, :, :40].any()
    with pytest.raises(ValueError):
        correlation_1d(f, f, max_displacement=1, kernel_size=2)


def test_correlation_1d_cuda_wrappers_refuse_cpu_tensors():
    before = correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches
    f = torch.zeros(1, 4, 4, 8)
    kw = dict(max_displacement=2, stride2=1, single_direction=-1)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_1d_cuda(f, f, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_1d_backward_cuda(f, f, torch.zeros(1, 3, 4, 4), **kw)
    assert (correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches) == before


def test_correlation_1d_plain_matches_jax_at_dispnet_width(rng):
    """What the card's 1-D kernels are held to, at DispNetC's real channel
    count and a real feature width (1x128x2x240, md 40, single_direction
    -1): correlation_1d_plain against correlation_1d_auto, and
    correlation_1d_backward_plain against jax.vjp of it; atol 1e-5 of
    max|ref| (float32 channel sums in another order)."""
    kw = dict(max_displacement=40, kernel_size=1, stride1=1, stride2=1, pad=40, single_direction=-1)
    f1, f2 = _corr1d_inputs(rng, (1, 2, 240, 128))
    out, vjp = jax.vjp(lambda a, b: correlation_1d_auto(a, b, **kw), jnp.asarray(f1), jnp.asarray(f2))
    got = nhwc(correlation_1d_plain(nchw(f1), nchw(f2), **kw))
    assert got.shape == out.shape == (1, 2, 240, 41)
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-5 * np.abs(np.asarray(out)).max())
    g = rng.standard_normal(out.shape).astype(np.float32)
    refs = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    for got, ref in zip(correlation_1d_backward_plain(nchw(f1), nchw(f2), nchw(g), **kw), refs):
        np.testing.assert_allclose(nhwc(got), ref, atol=1e-5 * np.abs(ref).max())


# Configurations outside the kernels' (multiply, k 1, stride1 1, pad ==
# md): the dispatchers send them to the plain versions on the card as on
# the CPU (tests/test_torch_gpu.py holds the card to the CPU on the same).
GENERAL_CONFIGS = {
    "k3": dict(max_displacement=4, kernel_size=3, stride1=1, stride2=1, pad=5),
    "stride1-2": dict(max_displacement=4, kernel_size=1, stride1=2, stride2=2, pad=4),
    "subtract": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=1, pad=4, multiply=False),
    "pad-below-md": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=2, pad=2),
}


@pytest.mark.parametrize("dims", ["2d", "1d"])
@pytest.mark.parametrize("case", sorted(GENERAL_CONFIGS))
def test_correlation_general_configs_match_jax(rng, case, dims):
    """correlation and correlation_1d through their dispatchers, forward and
    both gradients by autograd, against the JAX package's general scans
    (correlation, correlation_1d) and jax.vjp of them; atol 1e-5 of
    max|ref|."""
    kw = dict(GENERAL_CONFIGS[case])
    if dims == "1d":
        kw["single_direction"] = {"k3": 0, "stride1-2": -1, "subtract": 1, "pad-below-md": 0}[case]
    port, ref_fn = (correlation, jax_correlation) if dims == "2d" else (correlation_1d, jax_correlation_1d)
    f1 = rng.standard_normal((2, 9, 17, 6)).astype(np.float32)
    f2 = rng.standard_normal((2, 9, 17, 6)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: ref_fn(a, b, **kw), jnp.asarray(f1), jnp.asarray(f2))
    g = rng.standard_normal(out.shape).astype(np.float32)
    a, b = nchw(f1).requires_grad_(True), nchw(f2).requires_grad_(True)
    got = port(a, b, **kw)
    grads = torch.autograd.grad(got, (a, b), nchw(g))
    for x, ref in zip((got.detach(), *grads), (out, *vjp(jnp.asarray(g)))):
        ref = np.asarray(ref)
        assert nhwc(x).shape == ref.shape
        np.testing.assert_allclose(nhwc(x), ref, atol=1e-5 * np.abs(ref).max())


# -- Resample, channel norm, leaky ReLU --------------------------------------


@pytest.mark.parametrize(
    "in_hw,out_hw,antialias",
    [((16, 20), (64, 80), False), ((100, 150), (128, 192), True), ((30, 44), (17, 13), True),
     ((30, 44), (17, 13), False)],
)
def test_resample_matches_jax(rng, in_hw, out_hw, antialias):
    """atol 1e-5: the same weight matrices, float32 matmuls."""
    x = rng.uniform(-3, 3, (2, *in_hw, 3)).astype(np.float32)
    got = nhwc(resample(nchw(x), *out_hw, antialias=antialias))
    ref = np.asarray(jax_resample(jnp.asarray(x), *out_hw, method="linear", antialias=antialias))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resample_differentiates_after_an_inference_mode_call(rng):
    """The cached weight matrices made under inference_mode (FlowRunner.run)
    must serve a later training step: autograd refuses inference tensors."""
    x = torch.from_numpy(rng.standard_normal((1, 2, 7, 9)).astype(np.float32))
    with torch.inference_mode():
        resample(x, 28, 36, antialias=False)
    y = x.clone().requires_grad_(True)
    resample(y, 28, 36, antialias=False).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()


def test_resample_keeps_dtype_and_identity(rng):
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 8)).astype(np.float32)).bfloat16()
    assert resample(x, 16, 16).dtype == torch.bfloat16
    assert resample(x, 8, 8) is x


def test_channel_norm_matches_jax(rng):
    """rtol 1e-6: sum of squares and sqrt in float32."""
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    got = nhwc(channel_norm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jax_channel_norm(jnp.asarray(x))), rtol=1e-6)


def test_channel_norm_backward_is_stabilized_and_matches_jax(rng):
    """Exactly-zero channel vectors: the gradient is finite and equals
    jax.grad of the JAX custom-JVP op (rtol 1e-6); plain autograd of sqrt
    gives NaN there."""
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    x[0, 1:3, 2:4] = 0.0
    x[1, 4, 6] = 0.0
    w = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(jax_channel_norm(a) * w))(jnp.asarray(x))
    t = nchw(x).requires_grad_(True)
    (channel_norm(t) * nchw(w)).sum().backward()
    assert torch.isfinite(t.grad).all()
    np.testing.assert_allclose(nhwc(t.grad), np.asarray(ref), rtol=1e-6)


def test_leaky_relu_matches_jax(rng):
    x = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    got = nhwc(leaky_relu(nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_leaky_relu(jnp.asarray(x))))


# -- Weight bridge ----------------------------------------------------------------


def test_bridge_inverts_caffe_import(rng):
    """The port's weight move is the inverse of the caffemodel importer's:
    a Caffe OIHW blob imported to the JAX layout comes back exactly."""
    for deconv_layer in (False, True):
        blob = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
        w_jax = convert_conv_blob(CaffeBlob(shape=blob.shape, data=blob.ravel()), deconv=deconv_layer)
        sd = checkpoint.state_dict_from_params({"layer": {"w": w_jax, "b": np.zeros(4, np.float32)}})
        np.testing.assert_array_equal(sd["layer.weight"].numpy(), blob)


def test_bridge_conv_and_deconv_match_jax(rng):
    """atol 1e-4: a bridged conv (k7 s2) and deconv (k4 s2 p1) against
    ops/conv.conv2d and deconv2d_ps on the same weights."""
    x = rng.standard_normal((2, 12, 14, 6)).astype(np.float32)
    params = {
        "c": {"w": rng.standard_normal((7, 7, 6, 8)).astype(np.float32) * 0.1,
              "b": rng.standard_normal(8).astype(np.float32)},
        "d": {"w": rng.standard_normal((4, 4, 5, 6)).astype(np.float32) * 0.1,
              "b": rng.standard_normal(5).astype(np.float32)},
    }
    net = torch.nn.Module()
    net.c = conv(6, 8, 7, 2)
    net.d = deconv(6, 5)
    checkpoint.load_into(net, params)
    with torch.no_grad():
        got_c = nhwc(net.c(nchw(x)))
        got_d = nhwc(net.d(nchw(x)))
    ref_c = jax_conv2d(jnp.asarray(x), params["c"]["w"], params["c"]["b"], stride=2, padding=3)
    ref_d = jax_deconv2d_ps(jnp.asarray(x), params["d"]["w"], params["d"]["b"])
    np.testing.assert_allclose(got_c, np.asarray(ref_c), atol=1e-4)
    np.testing.assert_allclose(got_d, np.asarray(ref_d), atol=1e-4)


def test_bridge_rejects_unknown_leaf_and_shape_mismatch():
    with pytest.raises(ValueError):
        checkpoint.state_dict_from_params({"c": {"gamma": np.zeros(3)}})
    net = torch.nn.Module()
    net.c = conv(3, 4, 3)
    with pytest.raises(RuntimeError):
        checkpoint.load_into(net, {"c": {"w": np.zeros((3, 3, 3, 5), np.float32), "b": np.zeros(5, np.float32)}})


def test_init_params_msra_statistics():
    """Weights N(0, 2/(k*k*Cin)) in the JAX layout, biases 0, seeded."""
    p = checkpoint.init_params("flownets", seed=3)
    assert p["conv1/w"].shape == (7, 7, 6, 64)
    assert p["deconv5/w"].shape == (4, 4, 512, 1024)  # (kh, kw, Cout, Cin)
    std = (2.0 / (3 * 3 * 1024)) ** 0.5
    assert abs(p["conv6_1/w"].std() / std - 1) < 0.01
    assert not p["conv6_1/b"].any()
    np.testing.assert_array_equal(checkpoint.init_params("flownets", seed=3)["conv1/w"], p["conv1/w"])
