"""The port's head convolutions (K3's counterpart), fused fusion-net decoder
head (K4's), their routing, and run_flownet_many, against the JAX package
on the CPU.

Inputs and weights are numpy arrays from a seed, handed to both packages.
The JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; on CPU tensors the port runs its plain
versions (the CUDA kernels are held against those on the card in
tests/test_torch_gpu.py). Tolerances are atol 1e-4 in float32 (XLA's and
PyTorch's conv sums differ in order) and mean EPE 1e-3 px for whole nets.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flownet2_tpu.ops.pallas.s2d_conv as jax_s2d_conv
from flownet2_tpu.checkpoint import save_params, unflatten_params
from flownet2_tpu.cli.run_flownet_many import main as jax_many_main
from flownet2_tpu.core.flow_io import read_flo, write_ppm
from flownet2_tpu.inference import FlowRunner as JaxFlowRunner
from flownet2_tpu.models import flownet2_init
from flownet2_tpu.ops import s2d as jax_s2d
from flownet2_tpu.ops.activations import leaky_relu as jax_leaky_relu
from flownet2_tpu.ops.pallas.fusion_head import build_fusion_head_weights, fusion_head_pallas
from flownet2_tpu_torch import checkpoint
from flownet2_tpu_torch.cli.run_flownet_many import main as many_main
from flownet2_tpu_torch.inference import FlowRunner
from flownet2_tpu_torch.models import FlowNet2, flownet2_apply
from flownet2_tpu_torch.ops import fusion_head as fusion_head_op
from flownet2_tpu_torch.ops import head_conv
from flownet2_tpu_torch.ops.activations import leaky_relu as torch_leaky_relu
from flownet2_tpu_torch.ops.fusion_head import fusion_head, fusion_head_cuda
from flownet2_tpu_torch.ops.head_conv import (
    head_conv2d,
    head_conv2d_cuda,
    head_conv2d_plain,
    head_deconv2d,
    head_deconv2d_cuda,
    head_deconv2d_plain,
    pack_head_weight,
    pack_head_weight_f32,
    use_head_kernel,
)

torch.set_num_threads(2)  # the suite runs several workers side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _interpret(*args, **kwargs):
    kwargs["interpret"] = True
    return _PALLAS_CALL(*args, **kwargs)


_PALLAS_CALL = pl.pallas_call


def _epe(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


# -- K3: the head convs --------------------------------------------------------


@pytest.mark.parametrize("leaky", [False, True], ids=["linear", "leaky"])
@pytest.mark.parametrize(
    "k,stride,cin,cout",
    [(3, 1, 11, 64), (3, 1, 82, 16), (3, 1, 16, 2), (3, 2, 64, 64), (7, 2, 3, 64), (7, 2, 12, 64)],
    ids=["3x3s1-11-64", "3x3s1-82-16", "3x3s1-16-2", "3x3s2-64-64", "7x7s2-3-64", "7x7s2-12-64"],
)
def test_head_conv2d_matches_jax_s2d_kernel(rng, k, stride, cin, cout, leaky):
    """head_conv2d (plain NCHW) against the JAX package's s2d conv through
    its Pallas kernel (interpret mode) and through its XLA formulation."""
    x = rng.standard_normal((2, 18, 26, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    x2 = jax_s2d.space_to_depth(jnp.asarray(x))
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        routed = jax_s2d._conv2d_s2d_routed(x2, jnp.asarray(w), jnp.asarray(b), stride, None)
    impl = jax_s2d._conv2d_s2d_impl(x2, jnp.asarray(w), jnp.asarray(b), stride=stride)
    got = nhwc(head_conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                           stride=stride, leaky=leaky))
    for ref in (routed, impl):
        ref = jax_s2d.depth_to_space(ref) if stride == 1 else ref
        ref = np.asarray(jax_leaky_relu(ref) if leaky else ref)
        assert got.shape == ref.shape == (2, 18 // stride, 26 // stride, cout)
        np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("leaky", [False, True], ids=["linear", "leaky"])
@pytest.mark.parametrize("cin,cout", [(162, 16), (2, 2)])
def test_head_deconv2d_matches_jax_s2d_kernel(rng, cin, cout, leaky):
    """head_deconv2d (conv_transpose2d weights) against the JAX s2d deconv
    (Pallas kernel in interpret mode, and the XLA formulation)."""
    x = rng.standard_normal((2, 9, 13, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cout, cin)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        routed = jax_s2d._deconv2d_s2d_routed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    impl = jax_s2d._deconv2d_s2d_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = nhwc(head_deconv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                             leaky=leaky))
    for ref in (routed, impl):
        ref = jax_s2d.depth_to_space(ref)
        ref = np.asarray(jax_leaky_relu(ref) if leaky else ref)
        assert got.shape == ref.shape == (2, 18, 26, cout)
        np.testing.assert_allclose(got, ref, atol=ATOL)


# -- K3's bfloat16 route: the packed weight layout ------------------------------


def _packed_conv(x, weight, bias, *, stride, leaky):
    """The conv as the tensor-core kernel sums it: im2col columns in
    tap-major, channel-minor order (channels padded to cin_pad) times
    pack_head_weight's rows, then bias and leaky."""
    cout, cin, k, _ = weight.shape
    packed = pack_head_weight(weight, deconv=False)
    taps, cout_pad, cin_pad = packed.shape
    n, _, h, w = x.shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    cols = F.unfold(x, k, padding=k // 2, stride=stride).reshape(n, cin, taps, -1).transpose(1, 2)
    cols = F.pad(cols, (0, 0, 0, cin_pad - cin)).reshape(n, taps * cin_pad, -1)
    out = packed.permute(1, 0, 2).reshape(cout_pad, -1) @ cols
    out = out[:, :cout].reshape(n, cout, ho, wo) + bias[:, None, None]
    return torch_leaky_relu(out) if leaky else out


def _packed_deconv(x, weight, bias, *, leaky):
    """The k4/s2 deconv as the kernel sums it: per output phase (py, px), a
    2x2 im2col over the input padded by one, times the phase's four packed
    taps."""
    cin, cout = weight.shape[:2]
    packed = pack_head_weight(weight, deconv=True)
    _, cout_pad, cin_pad = packed.shape
    n, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = x.new_zeros(n, cout, 2 * h, 2 * w)
    for py in (0, 1):
        for px in (0, 1):
            phase = 2 * py + px
            cols = F.unfold(xp[:, :, py:py + h + 1, px:px + w + 1], 2).reshape(n, cin, 4, -1).transpose(1, 2)
            cols = F.pad(cols, (0, 0, 0, cin_pad - cin)).reshape(n, 4 * cin_pad, -1)
            wm = packed[4 * phase:4 * phase + 4].permute(1, 0, 2).reshape(cout_pad, -1)
            out[:, :, py::2, px::2] = (wm @ cols)[:, :cout].reshape(n, cout, h, w)
    out = out + bias[:, None, None]
    return torch_leaky_relu(out) if leaky else out


@pytest.mark.parametrize(
    "k,stride,cin,cout,leaky",
    [(3, 1, 11, 20, True), (3, 2, 19, 13, True), (7, 2, 3, 5, True), (3, 1, 82, 2, False)],
    ids=["3x3s1-11-20", "3x3s2-19-13", "7x7s2-3-5", "3x3s1-82-2"],
)
def test_packed_head_weight_conv_matches_plain_and_jax(rng, k, stride, cin, cout, leaky):
    """pack_head_weight's conv layout, as an im2col matmul in the kernel's K
    order, is the layer: against head_conv2d_plain and the JAX s2d conv
    through its Pallas kernel (interpret mode), float32, 1e-4."""
    x = rng.standard_normal((2, 18, 26, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    weight = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _packed_conv(nchw(x), weight, torch.from_numpy(b), stride=stride, leaky=leaky)
    plain = head_conv2d_plain(nchw(x), weight, torch.from_numpy(b), stride=stride, leaky=leaky)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        ref = jax_s2d._conv2d_s2d_routed(jax_s2d.space_to_depth(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
                                         stride, None)
    ref = jax_s2d.depth_to_space(ref) if stride == 1 else ref
    ref = np.asarray(jax_leaky_relu(ref) if leaky else ref)
    np.testing.assert_allclose(nhwc(got), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout,leaky", [(162, 13, True), (2, 2, False), (5, 9, True)])
def test_packed_head_weight_deconv_matches_plain_and_jax(rng, cin, cout, leaky):
    """pack_head_weight's deconv layout (four phases of four taps), as
    im2col matmuls, is the k4/s2 deconv: against head_deconv2d_plain and the
    JAX s2d deconv through its Pallas kernel (interpret mode), float32, 1e-4."""
    x = rng.standard_normal((2, 9, 13, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cout, cin)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    weight = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _packed_deconv(nchw(x), weight, torch.from_numpy(b), leaky=leaky)
    plain = head_deconv2d_plain(nchw(x), weight, torch.from_numpy(b), leaky=leaky)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        ref = jax_s2d._deconv2d_s2d_routed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = np.asarray(jax_s2d.depth_to_space(ref))
    np.testing.assert_allclose(nhwc(got), np.asarray(jax_leaky_relu(ref)) if leaky else ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("w_shape,deconv,packed_shape", [
    ((2, 3, 7, 7), False, (49, 8, 16)), ((16, 16, 3, 3), False, (9, 16, 16)), ((40, 82, 3, 3), False, (9, 64, 96)),
    ((162, 9, 4, 4), True, (16, 16, 176)), ((2, 2, 4, 4), True, (16, 8, 16)),
])
def test_packed_head_weight_shape_and_padding(w_shape, deconv, packed_shape):
    """(taps, cout_pad, cin_pad): Cout to the kernel's n-tile widths 8, 16 or
    64, Cin to a multiple of 16, zero in the padding, every weight kept
    once, the dtype kept."""
    weight = torch.randn(w_shape, generator=torch.Generator().manual_seed(0)).bfloat16()
    cin, cout = w_shape[:2] if deconv else w_shape[1::-1]
    packed = pack_head_weight(weight, deconv=deconv)
    assert packed.shape == packed_shape and packed.dtype == torch.bfloat16
    assert not packed[:, cout:].any() and not packed[:, :, cin:].any()
    kept = packed[:, :cout, :cin].flatten().float().sort().values
    assert torch.equal(kept, weight.flatten().float().sort().values)


# -- K3's float32 route: the packed weight layout --------------------------------


def _packed_conv_f32(x, weight, bias, *, stride, leaky):
    """The conv as the float32 kernel sums it: pack_head_weight_f32's
    (cin * taps, cout_pad) matrix against the im2col rows in channel-major,
    tap-minor order, then bias and leaky."""
    cout, cin, k, _ = weight.shape
    packed = pack_head_weight_f32(weight, deconv=False)
    n, _, h, w = x.shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    cols = F.unfold(x, k, padding=k // 2, stride=stride)  # (n, cin * k * k, ho * wo)
    out = packed.reshape(cin * k * k, -1).T @ cols
    out = out[:, :cout].reshape(n, cout, ho, wo) + bias[:, None, None]
    return torch_leaky_relu(out) if leaky else out


def _packed_deconv_f32(x, weight, bias, *, leaky):
    """The k4/s2 deconv as the float32 kernel sums it: per output phase, a
    2x2 im2col over the input padded by one against the phase's four taps
    of pack_head_weight_f32."""
    cin, cout = weight.shape[:2]
    packed = pack_head_weight_f32(weight, deconv=True)
    n, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = x.new_zeros(n, cout, 2 * h, 2 * w)
    for py in (0, 1):
        for px in (0, 1):
            phase = 2 * py + px
            cols = F.unfold(xp[:, :, py:py + h + 1, px:px + w + 1], 2)  # (n, cin * 4, h * w)
            wm = packed[:, 4 * phase:4 * phase + 4].reshape(cin * 4, -1).T
            out[:, :, py::2, px::2] = (wm @ cols)[:, :cout].reshape(n, cout, h, w)
    out = out + bias[:, None, None]
    return torch_leaky_relu(out) if leaky else out


F32_ATOL = 1e-5


@pytest.mark.parametrize(
    "k,stride,cin,cout,leaky",
    [(3, 1, 11, 64, True), (3, 1, 82, 16, False), (3, 1, 16, 2, False), (3, 2, 64, 64, True),
     (7, 2, 3, 64, True), (7, 2, 12, 64, True), (3, 1, 6, 40, True), (3, 2, 11, 3, False)],
    ids=["3x3s1-11-64", "3x3s1-82-16", "3x3s1-16-2", "3x3s2-64-64", "7x7s2-3-64", "7x7s2-12-64", "3x3s1-6-40",
         "3x3s2-11-3"],
)
def test_packed_head_weight_f32_conv_matches_plain_and_jax(rng, k, stride, cin, cout, leaky):
    """pack_head_weight_f32's conv layout, as an im2col matmul in the
    kernel's order, is the layer: against head_conv2d_plain and the JAX s2d
    conv through matmul_conv_pallas (interpret mode), float32, 1e-5."""
    x = rng.standard_normal((2, 18, 26, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    weight = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _packed_conv_f32(nchw(x), weight, torch.from_numpy(b), stride=stride, leaky=leaky)
    plain = head_conv2d_plain(nchw(x), weight, torch.from_numpy(b), stride=stride, leaky=leaky)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_ATOL, atol=F32_ATOL)
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        ref = jax_s2d._conv2d_s2d_routed(jax_s2d.space_to_depth(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
                                         stride, None)
    ref = jax_s2d.depth_to_space(ref) if stride == 1 else ref
    ref = np.asarray(jax_leaky_relu(ref) if leaky else ref)
    np.testing.assert_allclose(nhwc(got), ref, rtol=F32_ATOL, atol=F32_ATOL)


@pytest.mark.parametrize("cin,cout,leaky", [(162, 16, True), (2, 2, False), (5, 9, True)])
def test_packed_head_weight_f32_deconv_matches_plain_and_jax(rng, cin, cout, leaky):
    """pack_head_weight_f32's deconv layout (four phases of four taps per
    input channel), as im2col matmuls, is the k4/s2 deconv: against
    head_deconv2d_plain and the JAX s2d deconv through matmul_conv_pallas
    (interpret mode), float32, 1e-5."""
    x = rng.standard_normal((2, 9, 13, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cout, cin)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    weight = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _packed_deconv_f32(nchw(x), weight, torch.from_numpy(b), leaky=leaky)
    plain = head_deconv2d_plain(nchw(x), weight, torch.from_numpy(b), leaky=leaky)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_ATOL, atol=F32_ATOL)
    with mock.patch.object(jax_s2d_conv.pl, "pallas_call", _interpret):
        ref = jax_s2d._deconv2d_s2d_routed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = np.asarray(jax_s2d.depth_to_space(ref))
    np.testing.assert_allclose(nhwc(got), np.asarray(jax_leaky_relu(ref)) if leaky else ref, rtol=F32_ATOL,
                               atol=F32_ATOL)


@pytest.mark.parametrize("w_shape,deconv,packed_shape", [
    ((2, 3, 7, 7), False, (3, 49, 4)), ((16, 16, 3, 3), False, (16, 9, 16)), ((40, 82, 3, 3), False, (82, 9, 64)),
    ((162, 9, 4, 4), True, (162, 16, 16)), ((2, 2, 4, 4), True, (2, 16, 4)),
])
def test_packed_head_weight_f32_shape_and_padding(w_shape, deconv, packed_shape):
    """(cin, taps, cout_pad): Cout to the float32 kernel's channel blocks 4,
    16 or 64, zero in the padding, every weight kept once, the dtype kept,
    and one channel's weights a whole number of 16-byte units."""
    weight = torch.randn(w_shape, generator=torch.Generator().manual_seed(0))
    cout = w_shape[1] if deconv else w_shape[0]
    packed = pack_head_weight_f32(weight, deconv=deconv)
    assert packed.shape == packed_shape and packed.dtype == torch.float32 and packed.is_contiguous()
    assert not packed[..., cout:].any() and packed[0].numel() % 4 == 0
    kept = packed[..., :cout].flatten().sort().values
    assert torch.equal(kept, weight.flatten().sort().values)


def test_head_cuda_wrappers_refuse_cpu_tensors():
    x, w, b = torch.zeros(1, 3, 8, 8), torch.zeros(64, 3, 7, 7), torch.zeros(64)
    before = head_conv2d_cuda.launches, head_deconv2d_cuda.launches, fusion_head_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        head_conv2d_cuda(x, w, b, stride=2, leaky=True)
    with pytest.raises(ValueError, match="CUDA"):
        head_deconv2d_cuda(x, torch.zeros(3, 2, 4, 4), torch.zeros(2), leaky=False)
    net = FlowNet2().fusion
    with pytest.raises(ValueError, match="CUDA"):
        fusion_head_cuda(torch.zeros(1, 162, 4, 4), torch.zeros(1, 64, 8, 8), *fusion_head_op.head_weights(net))
    assert (head_conv2d_cuda.launches, head_deconv2d_cuda.launches, fusion_head_cuda.launches) == before


# -- K4: the fused fusion-net decoder head -----------------------------------


def _fusion_weights(seed: int):
    """Seeded FlowNet2 weights with random biases: (flat JAX-layout dict,
    the JAX fusion pytree, the port's fusion net)."""
    flat = checkpoint.init_params("flownet2", seed=seed)
    rng = np.random.default_rng(seed + 100)
    for key in flat:
        if key.startswith("fusion/") and key.endswith("/b"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32) * 0.3
    with torch.device("meta"):
        net = FlowNet2()
    checkpoint.load_into(net, flat)
    return flat, unflatten_params(flat)["fusion"], net.fusion


@pytest.mark.parametrize("shape", [(2, 40, 56), (1, 17, 130)])
def test_fusion_head_matches_jax_kernel_and_xla(rng, shape):
    """fusion_head (plain composition) against fusion_head_pallas (interpret)
    and _fusion_head_xla, borders included: half-resolution shapes as in
    tests/test_pallas.py, one of them not a multiple of any tile."""
    b, h2, w2 = shape
    _, p, net = _fusion_weights(seed=1)
    cat1 = rng.normal(0, 1, (b, h2, w2, 162)).astype(np.float32)
    c0 = rng.normal(0, 1, (b, 2 * h2, 2 * w2, 64)).astype(np.float32)
    c0_2 = jax_s2d.space_to_depth(jnp.asarray(c0))
    with torch.no_grad():
        flow0, flow1 = fusion_head(nchw(cat1), nchw(c0), net)
    kernel0, kernel1 = fusion_head_pallas(jnp.asarray(cat1), c0_2, build_fusion_head_weights(p, jnp.float32),
                                          interpret=True)
    xla0, xla1 = jax_s2d._fusion_head_xla(jnp.asarray(cat1), c0_2, p)
    for ref0, ref1 in ((kernel0, kernel1), (xla0, xla1)):
        np.testing.assert_allclose(nhwc(flow0), np.asarray(jax_s2d.depth_to_space(ref0)), atol=ATOL)
        np.testing.assert_allclose(nhwc(flow1), np.asarray(ref1), atol=ATOL)


def _conv_from_packed(x, packed, bias, cout, *, tc):
    """A 3x3 conv (pad 1) as im2col against packed weights: the tensor-core
    layout (taps, cout_pad, cin_pad) in tap-major, channel-minor K order, or
    the CUDA-core layout (cin, taps, cout_pad) in channel-major order."""
    n, cin, h, w = x.shape
    cols = F.unfold(x, 3, padding=1)  # (n, cin * 9, h * w), channel-major
    if tc:
        cin_pad = packed.shape[2]
        cols = F.pad(cols.reshape(n, cin, 9, -1).transpose(1, 2), (0, 0, 0, cin_pad - cin)).reshape(n, -1, h * w)
        wm = packed.permute(1, 0, 2).reshape(packed.shape[1], -1)
    else:
        wm = packed.reshape(cin * 9, -1).T
    return (wm @ cols)[:, :cout].reshape(n, cout, h, w) + bias[:, None, None]


def _deconv_from_packed(x, packed, bias, cout, *, tc):
    """The k4/s2 deconv as four phases of 2x2 im2col against packed weights
    (taps phase * 4 + a * 2 + b, in either layout of _conv_from_packed)."""
    n, cin, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = x.new_zeros(n, cout, 2 * h, 2 * w)
    for phase, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        cols = F.unfold(xp[:, :, py:py + h + 1, px:px + w + 1], 2)  # (n, cin * 4, h * w)
        if tc:
            cin_pad = packed.shape[2]
            cols = F.pad(cols.reshape(n, cin, 4, -1).transpose(1, 2), (0, 0, 0, cin_pad - cin)).reshape(n, -1, h * w)
            wm = packed[4 * phase:4 * phase + 4].permute(1, 0, 2).reshape(packed.shape[1], -1)
        else:
            wm = packed[:, 4 * phase:4 * phase + 4].reshape(cin * 4, -1).T
        out[:, :, py::2, px::2] = (wm @ cols)[:, :cout].reshape(n, cout, h, w)
    return out + bias[:, None, None]


def _head_from_packed(cat1, c0, packed, *, tc):
    """The six layers of the fused head computed from
    pack_fusion_head_weights' tensors, each in the K order its kernel sums
    (float32 arithmetic; upsample_flow1to0 always in the CUDA-core layout)."""
    w_i1, b_i1, w_pf1, b_pf1, w_dc, b_dc, w_up, b_up, w_i0, b_i0, w_pf0, b_pf0 = (t.float() for t in packed)
    inter1 = _conv_from_packed(cat1, w_i1, b_i1, 32, tc=tc)
    flow1 = _conv_from_packed(inter1, w_pf1, b_pf1, 2, tc=tc)
    upfeat = torch_leaky_relu(_deconv_from_packed(cat1, w_dc, b_dc, 16, tc=tc))
    upflow = _deconv_from_packed(flow1, w_up, b_up, 2, tc=False)
    inter0 = _conv_from_packed(torch.cat([c0, upfeat, upflow], 1), w_i0, b_i0, 16, tc=tc)
    return _conv_from_packed(inter0, w_pf0, b_pf0, 2, tc=tc), flow1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pack_fusion_head_weights_layouts(dtype):
    """Each packed weight has its kernel's shape and the dtype, is
    contiguous, zero in the padding and keeps every weight once; biases
    pass through."""
    _, _, net = _fusion_weights(seed=2)
    weights = tuple(t.detach().to(dtype) for t in fusion_head_op.head_weights(net))
    packed = fusion_head_op.pack_fusion_head_weights(*weights)
    tc = dtype == torch.bfloat16
    shapes = ([(9, 32, 176), (9, 8, 32), (16, 16, 176), (2, 16, 4), (9, 16, 96), (9, 8, 16)] if tc else
              [(162, 9, 32), (32, 9, 4), (162, 16, 16), (2, 16, 4), (82, 9, 16), (16, 9, 4)])
    for i, shape in enumerate(shapes):
        w, pw = weights[2 * i], packed[2 * i]
        assert tuple(pw.shape) == shape and pw.dtype == dtype and pw.is_contiguous()
        kept = pw.flatten().float()
        assert int((kept != 0).sum()) == int((w != 0).sum())
        assert torch.equal(kept[kept != 0].sort().values, w.flatten().float()[w.flatten() != 0].sort().values)
        assert packed[2 * i + 1] is weights[2 * i + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_fusion_head_matches_plain_and_jax(rng, dtype):
    """pack_fusion_head_weights' layouts, summed in each kernel's K order
    (float32 arithmetic on the dtype's weights), compute the head: against
    fusion_head_plain, the JAX package's _fusion_head_xla and its Pallas
    kernel on build_fusion_head_weights (interpret mode), 1e-4, borders
    included (a shape that is no multiple of any tile)."""
    flat, _, net = _fusion_weights(seed=3)
    weights = tuple(t.to(dtype).float() for t in fusion_head_op.head_weights(net))
    b, h2, w2 = 1, 11, 19
    cat1 = rng.normal(0, 1, (b, h2, w2, 162)).astype(np.float32)
    c0 = rng.normal(0, 1, (b, 2 * h2, 2 * w2, 64)).astype(np.float32)
    with torch.no_grad():
        got = _head_from_packed(nchw(cat1), nchw(c0), fusion_head_op.pack_fusion_head_weights(
            *(t.to(dtype) for t in weights)), tc=dtype == torch.bfloat16)
        plain = fusion_head_op.fusion_head_plain(nchw(cat1), nchw(c0), *weights)
    for a, r in zip(got, plain):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL)
    # the same (dtype-rounded) weights in the JAX layout
    rounded = {k: np.asarray(torch.from_numpy(np.asarray(v)).to(dtype).float()) for k, v in flat.items()}
    p = unflatten_params(rounded)["fusion"]
    c0_2 = jax_s2d.space_to_depth(jnp.asarray(c0))
    refs = (jax_s2d._fusion_head_xla(jnp.asarray(cat1), c0_2, p),
            fusion_head_pallas(jnp.asarray(cat1), c0_2, build_fusion_head_weights(p, jnp.float32), interpret=True))
    for ref0, ref1 in refs:
        np.testing.assert_allclose(nhwc(got[0]), np.asarray(jax_s2d.depth_to_space(ref0)), atol=ATOL)
        np.testing.assert_allclose(nhwc(got[1]), np.asarray(ref1), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 12, 20), (1, 9, 33)])
def test_head_unfused_matches_plain_and_jax(rng, shape):
    """FlowNetFusion.head_unfused, the route fusion_head=False takes and
    chip_smoke.py times against K4, computes the fused head's function on
    the CPU: against fusion_head_plain and the JAX package's
    _fusion_head_xla, 1e-4."""
    b, h2, w2 = shape
    flat, p, _ = _fusion_weights(seed=6)
    net = FlowNet2()
    checkpoint.load_into(net, flat)
    cat1 = rng.normal(0, 1, (b, h2, w2, 162)).astype(np.float32)
    c0 = rng.normal(0, 1, (b, 2 * h2, 2 * w2, 64)).astype(np.float32)
    with torch.no_grad():
        flow0, flow1 = net.fusion.head_unfused(nchw(cat1), nchw(c0))
        plain0, plain1 = fusion_head_op.fusion_head_plain(nchw(cat1), nchw(c0),
                                                          *fusion_head_op.head_weights(net.fusion))
    assert flow0.shape == (b, 2, 2 * h2, 2 * w2) and flow1.shape == (b, 2, h2, w2)
    np.testing.assert_allclose(flow0.numpy(), plain0.numpy(), atol=ATOL)
    np.testing.assert_allclose(flow1.numpy(), plain1.numpy(), atol=ATOL)
    ref0, ref1 = jax_s2d._fusion_head_xla(jnp.asarray(cat1), jax_s2d.space_to_depth(jnp.asarray(c0)), p)
    np.testing.assert_allclose(nhwc(flow0), np.asarray(jax_s2d.depth_to_space(ref0)), atol=ATOL)
    np.testing.assert_allclose(nhwc(flow1), np.asarray(ref1), atol=ATOL)


def test_flow_runner_fusion_head_matches_jax():
    """FlowNet2 with the fused head, through FlowRunner on the CPU, against
    the JAX FlowRunner at 100x150 (adapted to 128x192): mean EPE <= 1e-3 px."""
    flat, _, _ = _fusion_weights(seed=4)
    rng = np.random.default_rng(5)
    i0, i1 = (rng.uniform(0, 255, (2, 100, 150, 3)).astype(np.float32) for _ in range(2))
    ref = JaxFlowRunner("flownet2", unflatten_params(flat)).batch(i0, i1)
    runner = FlowRunner("flownet2", flat, device="cpu", fusion_head=True)
    assert runner.net.fusion.fusion_head
    got = runner.batch(i0, i1)
    assert got.shape == ref.shape == (2, 100, 150, 2)
    assert _epe(got, ref) <= 1e-3
    with pytest.raises(ValueError, match="flownet2"):
        FlowRunner("flownetc", checkpoint.init_params("flownetc"), device="cpu", fusion_head=True)


def test_fusion_head_option_keeps_the_weight_bridge():
    """FlowNet2(fusion_head=True) has the same state_dict as FlowNet2(), and
    both carry the JAX package's FlowNet2 parameter tree, key for key and
    shape for shape, through checkpoint's bridge."""
    jax_flat = {k: v.shape for k, v in checkpoint.flatten_params(flownet2_init(jax.random.PRNGKey(0))).items()}
    for fused in (False, True):
        with torch.device("meta"):
            net = FlowNet2(fusion_head=fused)
        bridged = checkpoint.params_from_state_dict(
            {k: torch.zeros(v.shape) for k, v in net.state_dict().items()})
        assert {k: v.shape for k, v in bridged.items()} == jax_flat


# -- routing --------------------------------------------------------------------


@pytest.mark.parametrize(
    "device,width,expected",
    [("cuda", 1024, True), ("cuda", 513, True), ("cuda", 512, False), ("cuda", 448, False),
     ("cpu", 1024, False), ("meta", 1024, False)],
)
def test_use_head_kernel_is_a_function_of_device_and_width(device, width, expected):
    """The K3 route: CUDA and full-resolution width > 512 (the JAX s2d width
    > 256, flownet2_tpu/ops/s2d.py:283-298)."""
    assert use_head_kernel(device, width) is expected


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-head"])
def test_flownet2_forward_routes_exactly_the_head_layers(monkeypatch, fused):
    """One FlowNet2 forward asks the routing 12 times (C conv1 per tower, S1
    and S2 conv1, SD conv0 and conv1, fusion conv0, conv1, deconv0,
    upsample_flow1to0, inter_conv0, predict_flow0), or 8 times plus one
    fused head. With the route forced to the kernel path (plain versions on
    the CPU), the flow is the one the layers' own modules give."""
    asked, heads = [], []
    real_head = fusion_head_op.fusion_head
    monkeypatch.setattr(fusion_head_op, "fusion_head", lambda *a: heads.append(1) or real_head(*a))
    flat = checkpoint.init_params("flownet2", seed=2)
    with torch.device("meta"):
        net = FlowNet2(fusion_head=fused)
    checkpoint.load_into(net, flat)
    rng = np.random.default_rng(8)
    i0, i1 = (torch.from_numpy(rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        ref = flownet2_apply(net, i0, i1).numpy()
        monkeypatch.setattr(head_conv, "use_head_kernel", lambda device, width: asked.append(width) or True)
        got = flownet2_apply(net, i0, i1).numpy()
    assert len(asked) == (8 if fused else 12) and len(heads) == 2 * fused
    assert sorted(set(asked)) == [128]  # every routed layer is full resolution
    np.testing.assert_allclose(got, ref, atol=1e-5)


# -- run_flownet_many -------------------------------------------------------------


@pytest.fixture
def many_jobs(tmp_path):
    """Two jobs of different resolutions (70x90 and 100x130), as list files
    naming separate outputs for the JAX and the port's CLI."""
    rng = np.random.default_rng(21)
    lines = {"jax": [], "torch": []}
    for j, (h, w) in enumerate([(70, 90), (100, 130)]):
        pair = []
        for i in range(2):
            p = tmp_path / f"job{j}_img{i}.ppm"
            write_ppm(p, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            pair.append(str(p))
        for side in lines:
            lines[side].append(f"{pair[0]} {pair[1]} {tmp_path / f'{side}{j}.flo'}")
    lists = {}
    for side, ls in lines.items():
        lists[side] = tmp_path / f"{side}.txt"
        lists[side].write_text("\n".join(ls) + "\n\n")
    return tmp_path, lists


def test_run_flownet_many_matches_jax(many_jobs):
    """Same .npz, same list of two resolutions: every .flo agrees with the
    JAX CLI's to mean EPE <= 1e-3 px (float32 on both sides)."""
    tmp, lists = many_jobs
    npz = str(tmp / "w.npz")
    save_params(npz, checkpoint.init_params("flownetc", seed=3))
    assert jax_many_main([npz, "flownetc", str(lists["jax"])]) == 0
    assert many_main([npz, "flownetc", str(lists["torch"]), "--device", "cpu"]) == 0
    for j, shape in enumerate([(70, 90, 2), (100, 130, 2)]):
        a, b = read_flo(tmp / f"jax{j}.flo"), read_flo(tmp / f"torch{j}.flo")
        assert a.shape == b.shape == shape
        assert _epe(a, b) <= 1e-3


_NO_JAX = """
import importlib.abc, sys

BLOCKED = ("jax", "flownet2_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, BlockJax())
import flownet2_tpu_torch.ops.head_conv, flownet2_tpu_torch.ops.fusion_head
from flownet2_tpu_torch.cli.run_flownet_many import main
rc = main(sys.argv[1:])
assert not [m for m in sys.modules if blocked(m)]
print("ran without jax, rc", rc)
"""


def test_run_flownet_many_runs_without_jax(many_jobs):
    """The port's run_flownet_many imports neither jax nor the JAX package."""
    tmp, lists = many_jobs
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "random", "flownets", str(lists["torch"]), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax, rc 0" in proc.stdout
    for j, shape in enumerate([(70, 90, 2), (100, 130, 2)]):
        flow = read_flo(tmp / f"torch{j}.flo")
        assert flow.shape == shape and np.isfinite(flow).all()


def test_run_flownet_many_without_card_refuses_to_fall_back(monkeypatch, many_jobs):
    tmp, lists = many_jobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        many_main(["random", "flownets", str(lists["torch"])])
    assert not (tmp / "torch0.flo").exists()


def test_run_flownet_many_rejects_bad_list_lines(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("a.ppm b.ppm\n")
    with pytest.raises(SystemExit, match="expected 'img0 img1 out.flo'"):
        many_main(["random", "flownets", str(bad), "--device", "cpu"])
    with pytest.raises(SystemExit, match="list file does not exist"):
        many_main(["random", "flownets", str(tmp_path / "missing.txt"), "--device", "cpu"])
