"""The CUDA kernels against their plain PyTorch versions, on the card, and
train steps on the card against the same steps on the CPU.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
where there is none. This file imports no jax, so on a machine without jax
it runs on its own, without tests/conftest.py (which imports jax):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.inference import FlowRunner
from flownet2_tpu_torch.models import DispNetC, FlowNet2, FlowNetC
from flownet2_tpu_torch.ops.correlation import (
    correlation,
    correlation_1d,
    correlation_1d_backward_cuda,
    correlation_1d_backward_plain,
    correlation_1d_cuda,
    correlation_1d_plain,
    correlation_backward_cuda,
    correlation_backward_plain,
    correlation_cuda,
    correlation_plain,
)
from flownet2_tpu_torch.ops.fusion_head import fusion_head, fusion_head_cuda, fusion_head_plain, head_weights
from flownet2_tpu_torch.ops.head_conv import (
    head_conv2d,
    head_conv2d_cuda,
    head_conv2d_plain,
    head_deconv2d,
    head_deconv2d_cuda,
    head_deconv2d_plain,
    head_launches,
)
from flownet2_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_backward_cuda,
    flow_warp_backward_plain,
    flow_warp_cuda,
    flow_warp_plain,
)
from flownet2_tpu_torch.train import objectives

pytestmark = pytest.mark.gpu

FLOWNETC_CORR = dict(max_displacement=20, kernel_size=1, stride1=1, stride2=2, pad=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _warp_inputs(device, n=2, c=3, h=64, w=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(n, c, h, w, generator=g) * 2 - 1
    flow = (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * 40
    flow[:, 0, :3, :3] = 500.0
    flow[:, :, 7, :4] = float("nan")
    return img.to(device), flow.to(device)


WARP_DTYPES = [  # (image, flow): every combination the kernels take
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
]


def _assert_warp_equal(got, ref):
    """NaN positions equal and the rest equal to 1e-6: kernel and plain
    version round the same float32 lerps."""
    np.testing.assert_array_equal(got.isnan().cpu().numpy(), ref.isnan().cpu().numpy())
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), atol=1e-6)


@pytest.mark.parametrize("fill", [0.0, float("nan")])
@pytest.mark.parametrize("img_dtype,flow_dtype", WARP_DTYPES)
def test_warp_kernel_matches_plain(cuda, fill, img_dtype, flow_dtype):
    """Kernel and plain version round the same float32 lerps: equal to 1e-6,
    and NaN positions equal."""
    img, flow = _warp_inputs(cuda)
    img, flow = img.to(img_dtype), flow.to(flow_dtype)
    before = flow_warp_cuda.launches
    got = flow_warp(img, flow, fill)
    torch.cuda.synchronize()
    assert flow_warp_cuda.launches == before + 1
    ref = flow_warp_plain(img, flow, fill)
    assert got.dtype == img_dtype
    _assert_warp_equal(got, ref)


# K1's and K2's edges: W 2 and 5 (no whole 4-pixel vector), 130 (a row tail
# after the vectors) and 448 (vectors only), H 2 and 9, C 1, 3 (the
# unrolled instance) and 5
WARP_EDGE_SHAPES = [(c, h, w) for w in (2, 5, 130, 448) for h in (2, 9) for c in (1, 3, 5)]


def _edge_flow(device, n, h, w, seed):
    """Random flows up to 0.6 * max(H, W) px, and per pixel, in turn, flows
    that land exactly on x2 = W-1, inside (W-1, W), just below 0, NaN, +inf,
    y2 = -inf, exactly on y2 = H-1, and inside (H-1, H)."""
    g = torch.Generator().manual_seed(seed)
    flow = (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * max(h, w) * 0.6
    ys, xs = (t.expand(n, h, w) for t in torch.meshgrid(
        torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32), indexing="ij"))
    case = (torch.arange(h * w).reshape(h, w) + 3 * torch.arange(n)[:, None, None]) % 10
    u, v = flow[:, 0], flow[:, 1]
    for k, target, value in ((1, u, w - 1 - xs), (2, u, w - 1 - xs + 0.5), (3, u, -xs - 0.25),
                             (7, v, h - 1 - ys), (8, v, h - 1 - ys + 0.5)):
        target[case == k] = value[case == k]
    u[case == 4], u[case == 5], v[case == 6] = float("nan"), float("inf"), float("-inf")
    return flow.to(device)


def _with_offset(t, offset):
    """``t`` as a contiguous tensor whose storage starts ``offset`` elements
    earlier (offset 1: the kernels' scalar path for misaligned pointers)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.storage_offset() == offset
    return out


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c,h,w", WARP_EDGE_SHAPES)
def test_warp_kernel_edges_match_plain(cuda, c, h, w, offset):
    """K1 at every dtype combination and fill, on shapes that split into
    vector runs, row tails and the scalar path, with image and flow
    starting at storage offset 0 or 1, and flows on and around each
    validity edge: equal to the plain version to 1e-6, NaN positions equal."""
    g = torch.Generator().manual_seed(100 * c + 10 * h + w)
    img32 = (torch.rand(2, c, h, w, generator=g) * 2 - 1).to(cuda)
    flow32 = _edge_flow(cuda, 2, h, w, seed=h + w + c)
    for img_dtype, flow_dtype in WARP_DTYPES:
        img, flow = _with_offset(img32.to(img_dtype), offset), _with_offset(flow32.to(flow_dtype), offset)
        for fill in (0.0, float("nan")):
            got = flow_warp_cuda(img, flow, fill)
            torch.cuda.synchronize()
            assert got.dtype == img_dtype
            _assert_warp_equal(got, flow_warp_plain(img, flow, fill))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c,h,w", WARP_EDGE_SHAPES)
def test_warp_backward_kernel_edges_match_plain(cuda, c, h, w, offset):
    """K2 on K1's edge cases, every dtype combination: both gradients
    within rel * max|ref| of autograd through the plain version (rel 1e-5
    for a float32 gradient, 2e-2 for a bfloat16 one), d_flow alone equal
    to the two-sided call's, and 0 wherever the flow is not finite."""
    g = torch.Generator().manual_seed(100 * c + 10 * h + w)
    img32 = (torch.rand(2, c, h, w, generator=g) * 2 - 1).to(cuda)
    grad32 = torch.randn(2, c, h, w, generator=g).to(cuda)
    flow32 = _edge_flow(cuda, 2, h, w, seed=h + w + c)
    for img_dtype, flow_dtype in WARP_DTYPES:
        img, flow = _with_offset(img32.to(img_dtype), offset), _with_offset(flow32.to(flow_dtype), offset)
        grad = _with_offset(grad32.to(img_dtype), offset)
        d_img, d_flow = flow_warp_backward_cuda(img, flow, grad)
        only_flow = flow_warp_backward_cuda(img, flow, grad, need_image=False)
        torch.cuda.synchronize()
        ref_img, ref_flow = flow_warp_backward_plain(img, flow, grad)
        assert d_img.dtype == img_dtype and d_flow.dtype == flow_dtype
        _rel_close(d_img, ref_img, 1e-5 if img_dtype == torch.float32 else 2e-2)
        _rel_close(d_flow, ref_flow, 1e-5 if flow_dtype == torch.float32 else 2e-2)
        assert only_flow[0] is None and torch.equal(only_flow[1], d_flow)
        assert not d_flow[~torch.isfinite(flow.float()).all(1, keepdim=True).expand_as(flow)].any()


@pytest.mark.parametrize("n,h,w", [(70000, 2, 4), (1, 1048600, 4)], ids=["batch-70000", "rows-1048600"])
def test_warp_kernels_grid_loops_match_plain(cuda, n, h, w):
    """A batch above the grid's 65535 blocks in z, and rows above its
    65535 x 16 in y: both kernels loop over the rest, float32, against the
    plain versions (K1 to 1e-6, K2 within 1e-5 * max|ref|)."""
    g = torch.Generator().manual_seed(n + h)
    img = (torch.rand(n, 1, h, w, generator=g) * 2 - 1).to(cuda)
    grad = torch.randn(n, 1, h, w, generator=g).to(cuda)
    flow = ((torch.rand(n, 2, h, w, generator=g) * 2 - 1) * 3).to(cuda)
    _assert_warp_equal(flow_warp_cuda(img, flow), flow_warp_plain(img, flow))
    for got, ref in zip(flow_warp_backward_cuda(img, flow, grad), flow_warp_backward_plain(img, flow, grad)):
        _rel_close(got, ref, 1e-5)


def test_warp_kernels_on_a_plane_of_2_31_elements(cuda):
    """A bfloat16 plane of 32768 x 65540 > 2^31 elements takes the 64-bit
    tap index instance. Flows 0 everywhere but the last 8 rows, where they
    are multiples of 1/8 up to 3 px (exact in float32 at these coordinates):
    K1 returns the image above them, and there, like K2, equals the plain
    version on a crop of the last 16 rows (K1 to 1e-6, K2's d_flow within
    2e-2 * max|ref| of a bfloat16 gradient)."""
    h, w, band = 32768, 65540, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(1, 1, h, w, generator=g, device=cuda, dtype=torch.bfloat16)
    flow = torch.zeros(1, 2, h, w, device=cuda, dtype=torch.bfloat16)
    flow[:, :, -band:] = (torch.randint(-24, 25, (1, 2, band, w), generator=g, device=cuda) / 8).bfloat16()
    out = flow_warp_cuda(img, flow)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, :-band], img[:, :, :-band])
    crop = (slice(None), slice(None), slice(h - 2 * band, h))
    _assert_warp_equal(out[crop], flow_warp_plain(img[crop], flow[crop]))
    del out
    grad = torch.rand(1, 1, h, w, generator=g, device=cuda, dtype=torch.bfloat16)
    _, d_flow = flow_warp_backward_cuda(img, flow, grad, need_image=False)
    torch.cuda.synchronize()
    _, ref = flow_warp_backward_plain(img[crop], flow[crop], grad[crop].contiguous())
    _rel_close(d_flow[crop][:, :, band:], ref[:, :, band:], 2e-2)


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_correlation_kernel_matches_plain(cuda, dtype, rel_tol):
    """f32: max abs <= 1e-5 * max|ref| (channel sums in another order);
    bf16: <= 2e-2 * max|ref| (one bf16 rounding of the output)."""
    g = torch.Generator().manual_seed(1)
    f1 = torch.randn(2, 256, 12, 14, generator=g).to(cuda, dtype)
    f2 = torch.randn(2, 256, 12, 14, generator=g).to(cuda, dtype)
    before = correlation_cuda.launches
    got = correlation(f1, f2, **FLOWNETC_CORR)
    torch.cuda.synchronize()
    assert correlation_cuda.launches == before + 1
    ref = correlation_plain(f1, f2, **FLOWNETC_CORR)
    assert got.shape == ref.shape == (2, 441, 12, 14) and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel_tol * ref.float().abs().max().item()


CORR_EDGE_CASES = [  # C, H, W, max_displacement, stride2: ragged widths, C not a chunk multiple
    (100, 9, 57, 4, 1), (100, 9, 57, 20, 2), (64, 7, 33, 20, 1), (256, 12, 14, 4, 2), (8, 5, 130, 20, 2),
]


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c,h,w,md,s2", CORR_EDGE_CASES)
def test_correlation_kernel_edges_match_plain(cuda, c, h, w, md, s2, dtype, rel_tol):
    """The forward at stride2 1 and 2, md 4 and 20, widths that cut its
    4-column runs and planes (57, 33, 130), channel counts that are not a
    multiple of its 16 (f32) or 32 (bf16) channel chunks (100, 8; 100 bf16
    also takes its 4-byte copies); within rel_tol * max|ref|."""
    g = torch.Generator().manual_seed(c + w)
    f1 = torch.randn(2, c, h, w, generator=g).to(cuda, dtype)
    f2 = torch.randn(2, c, h, w, generator=g).to(cuda, dtype)
    kw = dict(max_displacement=md, kernel_size=1, stride1=1, stride2=s2, pad=md)
    got = correlation(f1, f2, **kw)
    torch.cuda.synchronize()
    ref = correlation_plain(f1, f2, **kw)
    gw = 2 * (md // s2) + 1
    assert got.shape == ref.shape == (2, gw * gw, h, w) and got.dtype == dtype
    _rel_close(got, ref, rel_tol)


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    img, flow = _warp_inputs(cuda)
    with pytest.raises(TypeError):
        flow_warp(img.half(), flow)
    with pytest.raises(ValueError):
        flow_warp_cuda(img.transpose(2, 3).contiguous().transpose(2, 3), flow)
    with pytest.raises(ValueError):
        flow_warp(img, flow.cpu())
    f = torch.zeros(1, 8, 6, 6, device=cuda)
    with pytest.raises(ValueError):
        correlation(f, f.cpu(), max_displacement=2, kernel_size=3, pad=3)
    with pytest.raises(TypeError):
        correlation(f.half(), f.half(), max_displacement=2, pad=2)
    odd = torch.zeros(1, 6, 6, 9, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even"):
        correlation_cuda(odd, odd, max_displacement=2, stride2=1)
    with pytest.raises(ValueError, match="even"):
        correlation_backward_cuda(odd, odd, torch.zeros(1, 25, 6, 6, device=cuda, dtype=torch.bfloat16),
                                  max_displacement=2, stride2=1)


def test_flownet2_on_card_uses_kernels_and_matches_cpu(cuda):
    """One float32 FlowNet2 forward on the card launches 4 warps and 1
    correlation, and matches the same port on the CPU (plain versions) to
    mean EPE <= 1e-2 px (a warp tap on a validity edge may flip)."""
    params = init_params("flownet2", seed=0)
    rng = np.random.default_rng(0)
    i0, i1 = (rng.uniform(0, 255, (2, 64, 128, 3)).astype(np.float32) for _ in range(2))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runner = FlowRunner("flownet2", params, device=cuda)
        w0, c0 = flow_warp_cuda.launches, correlation_cuda.launches
        got = runner.batch(i0, i1)
        assert (flow_warp_cuda.launches - w0, correlation_cuda.launches - c0) == (4, 1)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = FlowRunner("flownet2", params, device="cpu").batch(i0, i1)
    assert float(np.sqrt(((got - ref) ** 2).sum(-1)).mean()) <= 1e-2


def _rel_close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|, in float32."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), f"max abs err {err} > {rel} * {ref.abs().max().item()}"


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_warp_backward_kernel_matches_plain(cuda, dtype, rel):
    """d_image (float32 atomics, then the image dtype) and d_flow, NaN flows
    included: within rel * max|ref| of autograd through the plain version;
    d_flow is exactly 0 at the NaN flows."""
    img, flow = _warp_inputs(cuda)
    img, flow = img.to(dtype), flow.to(dtype)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    before = flow_warp_backward_cuda.launches
    d_img, d_flow = flow_warp_backward_cuda(img, flow, g)
    torch.cuda.synchronize()
    assert flow_warp_backward_cuda.launches == before + 1
    ref_img, ref_flow = flow_warp_backward_plain(img, flow, g)
    assert d_img.dtype == d_flow.dtype == dtype
    _rel_close(d_img, ref_img, rel)
    _rel_close(d_flow, ref_flow, rel)
    assert not d_flow[:, :, 7, :4].any()
    only_flow = flow_warp_backward_cuda(img, flow, g, need_image=False)
    assert only_flow[0] is None and torch.equal(only_flow[1], d_flow)


# the backward's cases: the forward's edges, FlowNetC's md 20 / stride2 2
# at 256 channels, C 99 (float32 only: bfloat16 needs an even C), md 24 at
# stride2 1 (gw 49: g straight to shared memory) and stride2 20 (two plane groups)
CORR_BWD_CASES = [
    (*case, dtype, rel)
    for case in CORR_EDGE_CASES + [(256, 12, 14, 20, 2), (99, 9, 57, 4, 1), (64, 7, 33, 20, 2),
                                   (20, 6, 33, 24, 1), (8, 6, 40, 40, 20)]
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2))
    if case[0] % 2 == 0 or dtype == torch.float32
]


def _corr_bwd_inputs(device, dtype, n, c, h, w, md, s2, seed):
    """f1, f2 (N, C, H, W) and a cotangent (N, gw**2, H, W), seeded."""
    g0 = torch.Generator().manual_seed(seed)
    gw = 2 * (md // s2) + 1
    f1, f2 = (torch.randn(n, c, h, w, generator=g0).to(device, dtype) for _ in range(2))
    return f1, f2, torch.randn(n, gw * gw, h, w, generator=g0).to(device, dtype)


@pytest.mark.parametrize("c,h,w,md,s2,dtype,rel", CORR_BWD_CASES)
def test_correlation_backward_kernel_matches_plain(cuda, c, h, w, md, s2, dtype, rel):
    """Gradients through correlation on the card (forward kernel, then one
    launch of the backward kernel for both df1 and df2) against
    correlation_backward_plain: f32 within 1e-5 * max|ref| (sums in another
    order), bf16 within 2e-2 * max|ref| (one bf16 rounding of the output).
    Strides 1, 2 and 20 (planes in two groups), md 4, 20 and 24 (1681 and
    2401 displacements at stride2 1: the second too many g values a row
    for registers), widths that cut the 4-column runs of either plane (57,
    33, 130, 14), channel counts that are not a multiple of the 64-channel
    runs (100, 99, 8, 20), and the 4-byte copies (C 99 in float32, C 100
    and 20 in bfloat16)."""
    f1, f2, grad = _corr_bwd_inputs(cuda, dtype, 2, c, h, w, md, s2, seed=c + w + md)
    kw = dict(max_displacement=md, kernel_size=1, stride1=1, stride2=s2, pad=md)
    a, b = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
    before = correlation_backward_cuda.launches
    got = torch.autograd.grad(correlation(a, b, **kw), (a, b), grad)
    torch.cuda.synchronize()
    assert correlation_backward_cuda.launches == before + 1
    ref = correlation_backward_plain(f1, f2, grad, **kw)
    for x, y in zip(got, ref):
        assert x.shape == y.shape == (2, c, h, w) and x.dtype == dtype
        _rel_close(x, y, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", ["f1", "f2"])
def test_correlation_backward_kernel_one_sided(cuda, need, dtype):
    """need_f1 only or need_f2 only: one launch, the other gradient None, and
    the one asked for equal to the same gradient of the two-sided call."""
    f1, f2, grad = _corr_bwd_inputs(cuda, dtype, 2, 64, 9, 30, 20, 2, seed=7)
    nhwc = (lambda t: t.permute(0, 2, 3, 1).contiguous())
    both = correlation_backward_cuda(nhwc(f1), nhwc(f2), grad, max_displacement=20, stride2=2)
    before = correlation_backward_cuda.launches
    got = correlation_backward_cuda(nhwc(f1), nhwc(f2), grad, max_displacement=20, stride2=2,
                                    need_f1=need == "f1", need_f2=need == "f2")
    torch.cuda.synchronize()
    assert correlation_backward_cuda.launches == before + 1
    k = 0 if need == "f1" else 1
    assert got[1 - k] is None
    assert torch.equal(got[k], both[k])
    _rel_close(got[k], nhwc(correlation_backward_plain(f1, f2, grad, **FLOWNETC_CORR)[k]),
               1e-5 if dtype == torch.float32 else 2e-2)


def test_correlation_backward_kernel_at_sintel_features(cuda):
    """FlowNetC's backward at Sintel b4's conv3 features, 4x256x56x128
    (two column tiles of each plane), float32: within 1e-5 * max|ref|."""
    f1, f2, grad = _corr_bwd_inputs(cuda, torch.float32, 4, 256, 56, 128, 20, 2, seed=8)
    nhwc = (lambda t: t.permute(0, 2, 3, 1).contiguous())
    df1, df2 = correlation_backward_cuda(nhwc(f1), nhwc(f2), grad, max_displacement=20, stride2=2)
    torch.cuda.synchronize()
    ref1, ref2 = correlation_backward_plain(f1, f2, grad, **FLOWNETC_CORR)
    _rel_close(df1, nhwc(ref1), 1e-5)
    _rel_close(df2, nhwc(ref2), 1e-5)


@pytest.mark.parametrize("fill", [0.0, float("nan")])
def test_autograd_through_the_kernels_matches_plain(cuda, fill):
    """torch.autograd.grad through flow_warp and correlation on the card
    (the kernels' autograd Functions) equals the same call on the CPU (the
    plain versions), with strided incoming gradients."""
    img, flow = _warp_inputs(cuda)
    ic, fc = img.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    ip, fp = img.cpu().requires_grad_(True), flow.cpu().requires_grad_(True)
    g = torch.randn(img.shape[0], img.shape[2], img.shape[3], img.shape[1],
                    generator=torch.Generator().manual_seed(5)).permute(0, 3, 1, 2)  # not contiguous
    b0, f0 = flow_warp_backward_cuda.launches, flow_warp_cuda.launches
    got = torch.autograd.grad(flow_warp(ic, fc, fill), (ic, fc), g.to(cuda))
    assert (flow_warp_cuda.launches - f0, flow_warp_backward_cuda.launches - b0) == (1, 1)
    ref = torch.autograd.grad(flow_warp(ip, fp, fill), (ip, fp), g)
    for a, b in zip(got, ref):
        _rel_close(a, b, 1e-5)

    g0 = torch.Generator().manual_seed(6)
    f1, f2 = (torch.randn(2, 64, 10, 12, generator=g0) for _ in range(2))
    a, b = f1.to(cuda).requires_grad_(True), f2.to(cuda).requires_grad_(True)
    gc = torch.randn(2, 441, 10, 12, generator=g0)
    c0 = correlation_backward_cuda.launches
    got = torch.autograd.grad(correlation(a, b, **FLOWNETC_CORR), (a, b), gc.to(cuda))
    assert correlation_backward_cuda.launches - c0 == 1
    ap, bp = f1.requires_grad_(True), f2.requires_grad_(True)
    ref = torch.autograd.grad(correlation(ap, bp, **FLOWNETC_CORR), (ap, bp), gc)
    for x, y in zip(got, ref):
        assert x.shape == y.shape
        _rel_close(x, y, 1e-5)


def _smooth_batch(n=1, h=64, w=128, seed=11):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.05, (n, 1, 1, 3))
    img0 = 127.5 + 60 * np.sin(xs[None, ..., None] * f + ys[None, ..., None] * f[..., ::-1])
    flow = rng.normal(0, 2, (n, h, w, 2)).astype(np.float32)
    return {"img0": img0.astype(np.float32), "img1": np.roll(img0, 2, axis=2).astype(np.float32), "flow": flow}


def _loss_and_grads(flat, batch, loss_fn, sub_name, device):
    with torch.device("meta"):
        net = FlowNet2()
    net = load_into(net, flat).to(device)
    for p in net.parameters():
        p.requires_grad_(False)
    sub = net if sub_name is None else getattr(net, sub_name)
    for p in sub.parameters():
        p.requires_grad_(True)
    loss, _ = loss_fn(net, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in sub.named_parameters()}


def _grad_errors(grads, ref):
    """Relative L2 error of all tensors together, and of the median tensor."""
    diff = sum(((grads[k] - r) ** 2).sum().item() for k, r in ref.items())
    norm = sum((r ** 2).sum().item() for r in ref.values())
    per = sorted(((grads[k] - r).norm() / r.norm()).item() for k, r in ref.items())
    return (diff / norm) ** 0.5, per[len(per) // 2]


@pytest.mark.parametrize("case", ["flownetc-stage", "joint"])
def test_train_step_on_card_uses_kernels_and_matches_cpu(cuda, case):
    """One float32 loss and gradient on the card (TF32 off, cuDNN's
    deterministic algorithms) against the port on the CPU, on three batches:
    loss rtol 1e-4; the gradients' relative L2 error over all tensors
    together <= 1e-3 and the median tensor's <= 1e-3. The FlowNetC stage
    launches the correlation forward and backward once each; the joint loss
    also 4 warps and 4 warp backwards.

    The gradients are held as a whole because kinks of the random net
    (leaky ReLUs, warp tap boundaries) within float32 noise of their inputs
    flip between the card and the CPU and move some tensors by 1e-3 to
    1e-2; moving the CPU's input by 1e-6 does the same
    (scripts/probe_grads.py)."""
    loss_fn, sub, counts = {
        "flownetc-stage": (objectives.LOSSES["flownet2-c-stage"], "flownetc", (0, 0, 1, 1)),
        "joint": (objectives.flownet2_loss, None, (4, 4, 1, 1)),
    }[case]
    flat = init_params("flownet2", seed=3)
    kernels = (flow_warp_cuda, flow_warp_backward_cuda, correlation_cuda, correlation_backward_cuda)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    for seed in (11, 12, 13):
        batch = _smooth_batch(seed=seed)
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        cudnn.deterministic = True
        try:
            before = [k.launches for k in kernels]
            loss, grads = _loss_and_grads(flat, batch, loss_fn, sub, cuda)
            assert tuple(k.launches - b for k, b in zip(kernels, before)) == counts
        finally:
            cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = flags
        ref_loss, ref_grads = _loss_and_grads(flat, batch, loss_fn, sub, "cpu")
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
        whole, median = _grad_errors(grads, ref_grads)
        assert whole <= 1e-3 and median <= 1e-3, f"seed {seed}: relative L2 of all {whole:.3g}, median {median:.3g}"


@pytest.fixture
def no_tf32():
    """cuDNN's float32 convs in full float32, as the plain versions need."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _conv_inputs(device, dtype, x_shape, w_shape, seed, deconv=False):
    """x, weight (OIHW, or (Cin, Cout, 4, 4) for a deconv) and bias, seeded."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(x_shape, generator=g)
    weight = torch.randn(w_shape, generator=g) * 0.1
    bias = torch.randn(w_shape[1] if deconv else w_shape[0], generator=g)
    return tuple(t.to(device, dtype) for t in (x, weight, bias))


HEAD_CONV_CASES = [  # k, stride, cin, cout, leaky: the nets' head geometries, one masked Cout, and
    # Cin 162 and 82 and Cout 2 at the other geometries (bf16: Cin padded to 16s, Cout to 8, 16 or 64)
    (3, 1, 11, 64, True), (3, 1, 82, 16, False), (3, 1, 16, 2, False), (3, 2, 64, 64, True),
    (7, 2, 3, 64, True), (7, 2, 12, 64, True), (3, 1, 6, 40, True), (3, 1, 6, 64, True),
    (3, 1, 162, 16, True), (3, 2, 11, 2, False), (7, 2, 82, 16, True),
]
DTYPE_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.mark.parametrize("dtype,rel", DTYPE_TOLS)
@pytest.mark.parametrize("k,stride,cin,cout,leaky", HEAD_CONV_CASES)
def test_head_conv_kernel_matches_plain(cuda, no_tf32, k, stride, cin, cout, leaky, dtype, rel):
    """K3's conv at ragged sizes (tiles cut at the right and bottom edges;
    odd output widths at stride 2), float32 on the CUDA cores and bfloat16
    on the tensor cores: within rel * max|ref| of F.conv2d plus leaky on the
    same inputs."""
    x, w, b = _conv_inputs(cuda, dtype, (2, cin, 37, 150), (cout, cin, k, k), seed=k * 100 + cin)
    before = head_conv2d_cuda.launches
    got = head_conv2d(x, w, b, stride=stride, leaky=leaky)
    torch.cuda.synchronize()
    assert head_conv2d_cuda.launches == before + 1
    ref = head_conv2d_plain(x, w, b, stride=stride, leaky=leaky)
    assert got.shape == ref.shape and got.dtype == dtype
    _rel_close(got, ref, rel)


@pytest.mark.parametrize("dtype,rel", DTYPE_TOLS)
@pytest.mark.parametrize("cin,cout,leaky", [(162, 16, True), (2, 2, False), (5, 9, True)])
def test_head_deconv_kernel_matches_plain(cuda, no_tf32, cin, cout, leaky, dtype, rel):
    """K3's k4/s2 deconv (conv_transpose2d weights, all four phases)."""
    x, w, b = _conv_inputs(cuda, dtype, (2, cin, 19, 70), (cin, cout, 4, 4), seed=cin, deconv=True)
    before = head_deconv2d_cuda.launches
    got = head_deconv2d(x, w, b, leaky=leaky)
    torch.cuda.synchronize()
    assert head_deconv2d_cuda.launches == before + 1
    ref = head_deconv2d_plain(x, w, b, leaky=leaky)
    assert got.shape == ref.shape == (2, cout, 38, 140) and got.dtype == dtype
    _rel_close(got, ref, rel)


@pytest.mark.parametrize("hw", [(17, 65), (70, 257)], ids=["17x65", "70x257"])
@pytest.mark.parametrize("k,stride,cin,cout", [
    (7, 2, 3, 64), (3, 1, 11, 64), (3, 2, 162, 64), (3, 1, 82, 16), (7, 2, 11, 16), (3, 2, 162, 2), (3, 1, 3, 2),
])
def test_head_conv_f32_tile_and_chunk_edges(cuda, no_tf32, hw, k, stride, cin, cout):
    """K3's float32 route where its tiles and channel chunks are cut: Cin
    not a multiple of any chunk (3, 11, 82, 162), Cout 2, 16 and 64 (its
    4-, 16- and 64-channel blocks), heights and widths that cut the tiles
    (4 x 64, 8 x 128 and 16 x 128 outputs) at both strides; within 1e-5 *
    max|ref| of the plain version."""
    x, w, b = _conv_inputs(cuda, torch.float32, (2, cin, *hw), (cout, cin, k, k), seed=cin + cout)
    got = head_conv2d_cuda(x, w, b, stride=stride, leaky=True)
    torch.cuda.synchronize()
    ref = head_conv2d_plain(x, w, b, stride=stride, leaky=True)
    assert got.shape == ref.shape
    _rel_close(got, ref, 1e-5)


@pytest.mark.parametrize("hw", [(9, 65), (35, 129)], ids=["9x65", "35x129"])
@pytest.mark.parametrize("cin,cout", [(3, 16), (11, 2), (82, 16), (162, 16), (162, 2)])
def test_head_deconv_f32_tile_and_chunk_edges(cuda, no_tf32, hw, cin, cout):
    """K3's float32 deconv where its tiles (4 x 64 and 4 x 128
    half-resolution positions) and chunks (16 and 8 channels) are cut."""
    x, w, b = _conv_inputs(cuda, torch.float32, (2, cin, *hw), (cin, cout, 4, 4), seed=cin, deconv=True)
    got = head_deconv2d_cuda(x, w, b, leaky=False)
    torch.cuda.synchronize()
    ref = head_deconv2d_plain(x, w, b, leaky=False)
    assert got.shape == ref.shape == (2, cout, 2 * hw[0], 2 * hw[1])
    _rel_close(got, ref, 1e-5)


def _fusion_net(device, dtype, seed=5):
    """A fusion net with seeded weights and random biases."""
    flat = init_params("flownet2", seed=seed)
    rng = np.random.default_rng(seed)
    for key in flat:
        if key.startswith("fusion/") and key.endswith("/b"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32) * 0.3
    with torch.device("meta"):
        net = FlowNet2()
    return load_into(net, flat).fusion.to(device, dtype)


# (N, H2, W2): the half-resolution sizes; K4's flow1 tile is 16 x 16
FUSION_HEAD_SHAPES = [
    (2, 21, 70), (1, 8, 16), (1, 40, 100),
    (1, 15, 17), (1, 17, 15), (1, 16, 16), (1, 1, 20), (2, 9, 1), (3, 16, 16), (2, 160, 224),
]


@pytest.mark.parametrize("dtype,rel", DTYPE_TOLS)
@pytest.mark.parametrize("shape", FUSION_HEAD_SHAPES, ids=["x".join(map(str, s)) for s in FUSION_HEAD_SHAPES])
def test_fusion_head_kernel_matches_plain(cuda, no_tf32, shape, dtype, rel):
    """K4 in one launch against the six plain layers, on sizes that are not
    tile multiples (the per-stage border masks show only at the edges): one
    below and one above the 16 x 16 half-resolution tile in each direction,
    exactly one tile, a height or width of 1, batch 3, 448x320's size, and
    odd half-resolution widths (2-byte loads in the bf16 route)."""
    n, h2, w2 = shape
    net = _fusion_net(cuda, dtype)
    g = torch.Generator().manual_seed(h2)
    cat1 = torch.randn(n, 162, h2, w2, generator=g).to(cuda, dtype)
    c0 = torch.randn(n, 64, 2 * h2, 2 * w2, generator=g).to(cuda, dtype)
    before = fusion_head_cuda.launches
    with torch.no_grad():
        got = fusion_head(cat1, c0, net)
        torch.cuda.synchronize()
        assert fusion_head_cuda.launches == before + 1
        ref = fusion_head_plain(cat1, c0, *head_weights(net))
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == dtype
        _rel_close(a, r, rel)


def test_fusion_head_bf16_kernel_runs_on_the_tensor_cores(cuda):
    """K4's bfloat16 kernel has HMMA (tensor-core) instructions in its SASS;
    its float32 kernel has none (exact float32 on the CUDA cores)."""
    from flownet2_tpu_torch import _build

    counts = _build.hmma_counts(("fusion_head",))
    tc = {k: c for k, c in counts.items() if "fusion_head_tc" in k}
    f32 = {k: c for k, c in counts.items() if "fusion_head_f32" in k}
    assert len(tc) == 1 and sum(tc.values()) > 0
    assert len(f32) == 1 and sum(f32.values()) == 0


def test_head_autograd_matches_plain(cuda, no_tf32):
    """Gradients through the K3 and K4 autograd Functions (backward:
    autograd through the plain versions) equal autograd through the plain
    versions, also after a forward under inference_mode."""
    x, w, b = _conv_inputs(cuda, torch.float32, (2, 11, 20, 40), (64, 11, 3, 3), seed=1)
    with torch.inference_mode():
        head_conv2d(x, w, b, stride=1, leaky=True)
    for fn, plain, args, kw in (
        (head_conv2d, head_conv2d_plain, (x, w, b), dict(stride=2, leaky=True)),
        (head_deconv2d, head_deconv2d_plain,
         _conv_inputs(cuda, torch.float32, (2, 6, 9, 12), (6, 4, 4, 4), seed=2, deconv=True), dict(leaky=True)),
    ):
        a = [t.clone().requires_grad_(True) for t in args]
        got = torch.autograd.grad(fn(*a, **kw).square().sum(), a)
        p = [t.clone().requires_grad_(True) for t in args]
        ref = torch.autograd.grad(plain(*p, **kw).square().sum(), p)
        for x_, r_ in zip(got, ref):
            _rel_close(x_, r_, 1e-5)

    net = _fusion_net(cuda, torch.float32)
    g = torch.Generator().manual_seed(3)
    cat1 = torch.randn(1, 162, 10, 12, generator=g).to(cuda).requires_grad_(True)
    c0 = torch.randn(1, 64, 20, 24, generator=g).to(cuda).requires_grad_(True)
    f0, f1 = fusion_head(cat1, c0, net)
    got = torch.autograd.grad(f0.square().sum() + f1.sum(), [cat1, c0, net.inter_conv0.weight])
    r0, r1 = fusion_head_plain(cat1, c0, *head_weights(net))
    ref = torch.autograd.grad(r0.square().sum() + r1.sum(), [cat1, c0, net.inter_conv0.weight])
    for x_, r_ in zip(got, ref):
        _rel_close(x_, r_, 1e-5)


def test_head_wrappers_raise_on_what_they_do_not_take(cuda):
    x, w, b = _conv_inputs(cuda, torch.float32, (1, 3, 8, 8), (64, 3, 7, 7), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        head_conv2d_cuda(x.cpu(), w, b, stride=2, leaky=True)
    with pytest.raises(TypeError):
        head_conv2d_cuda(x.half(), w.half(), b.half(), stride=2, leaky=True)
    with pytest.raises(TypeError):
        head_conv2d_cuda(x.bfloat16(), w, b, stride=2, leaky=True)
    with pytest.raises(ValueError, match="contiguous"):
        head_conv2d_cuda(x.transpose(2, 3), w, b, stride=2, leaky=True)
    with pytest.raises(ValueError, match="covers"):
        head_conv2d_cuda(x, w, b, stride=1, leaky=True)  # 7x7 stride 1
    with pytest.raises(ValueError, match="covers"):
        head_conv2d_cuda(x, torch.zeros(65, 3, 3, 3, device=cuda), torch.zeros(65, device=cuda), stride=1,
                         leaky=False)
    dx, dw, db = _conv_inputs(cuda, torch.float32, (1, 4, 8, 8), (4, 17, 4, 4), seed=0, deconv=True)
    with pytest.raises(ValueError, match="covers"):
        head_deconv2d_cuda(dx, dw, db, leaky=False)  # Cout 17
    with pytest.raises(ValueError, match="contiguous"):
        head_deconv2d_cuda(dx.transpose(2, 3), dw[:, :4].contiguous(), db[:4], leaky=False)
    net = _fusion_net(cuda, torch.float32)
    cat1, c0 = torch.zeros(1, 162, 4, 4, device=cuda), torch.zeros(1, 64, 8, 8, device=cuda)
    weights = head_weights(net)
    with pytest.raises(ValueError, match="CUDA"):
        fusion_head_cuda(cat1.cpu(), c0, *weights)
    with pytest.raises(TypeError):
        fusion_head_cuda(cat1.bfloat16(), c0.bfloat16(), *weights)
    with pytest.raises(ValueError, match="contiguous"):
        fusion_head_cuda(cat1.transpose(2, 3), c0, *weights)
    with pytest.raises(ValueError, match="does not fit"):
        fusion_head_cuda(cat1, c0[:, :, :6].contiguous(), *weights)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-head"])
def test_flownet2_wide_on_card_uses_head_kernels_and_matches_cpu(cuda, no_tf32, fused):
    """At 64x576 (full-resolution width above 512) one float32 FlowNet2
    forward launches K3 12 times (8 with the fused head, plus K4 once),
    matches the port on the CPU to mean EPE <= 1e-2 px, and the fused head
    matches the unfused forward on the card to 1e-3 px."""
    params = init_params("flownet2", seed=0)
    rng = np.random.default_rng(1)
    i0, i1 = (rng.uniform(0, 255, (2, 64, 576, 3)).astype(np.float32) for _ in range(2))
    runner = FlowRunner("flownet2", params, device=cuda, fusion_head=fused)
    k3, k4 = head_launches(), fusion_head_cuda.launches
    got = runner.batch(i0, i1)
    assert (head_launches() - k3, fusion_head_cuda.launches - k4) == ((8, 1) if fused else (12, 0))
    ref = FlowRunner("flownet2", params, device="cpu").batch(i0, i1)
    assert float(np.sqrt(((got - ref) ** 2).sum(-1)).mean()) <= 1e-2
    if fused:
        unfused = FlowRunner("flownet2", params, device=cuda).batch(i0, i1)
        assert float(np.sqrt(((got - unfused) ** 2).sum(-1)).mean()) <= 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-head"])
def test_flownet2_wide_bf16_on_card_uses_head_kernels(cuda, fused):
    """At 64x576 one bfloat16 FlowNet2 forward launches K3's tensor-core
    route 12 times (8 with the fused head, plus K4 once) and gives a finite
    flow of the input's shape. (bf16 against f32 under random weights is
    chaotic: no closeness check.)"""
    params = init_params("flownet2", seed=0)
    rng = np.random.default_rng(2)
    i0, i1 = (rng.uniform(0, 255, (2, 64, 576, 3)).astype(np.float32) for _ in range(2))
    runner = FlowRunner("flownet2", params, device=cuda, dtype="bfloat16", fusion_head=fused)
    k3, k4 = head_launches(), fusion_head_cuda.launches
    got = runner.batch(i0, i1)
    assert (head_launches() - k3, fusion_head_cuda.launches - k4) == ((8, 1) if fused else (12, 0))
    assert got.shape == (2, 64, 576, 2) and np.isfinite(got).all()


@pytest.fixture
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: at these small shapes its default
    float32 choices give another flow from call to call on the same frames
    (up to 0.1 px over a FlowNet2 forward on an H100; none at Sintel b4)."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


# max |flow difference| in px, card against the CPU reference, by updates: float32
# on cuDNN's algorithms rounds otherwise than on the CPU, and the random-weight
# recurrence amplifies it (at this size the reference in float64 parts from
# float32 by 3.8e-5 px after one update and 2.8e-4 after four; an H100 read
# 6.6e-5 and 6.2e-4): about 30 times what the card reads
RAFT_CARD_TOLERANCE = {1: 2e-3, 4: 2e-2}


@pytest.mark.parametrize("iters", sorted(RAFT_CARD_TOLERANCE))
def test_raft_on_the_card_equals_the_reference(cuda, cudnn_deterministic, iters):
    """``FlowRunner("raft")`` on the card (TF32 off) against the plain
    reference of ``tests/raft_reference.py`` on the CPU: two 124x190 pairs,
    padded on both axes, through ``batch``, and one through ``__call__``."""
    import raft_reference

    from flownet2_tpu_torch.checkpoint import expected_params

    weights = raft_reference.seeded_weights(expected_params("raft"), 3)
    rng = np.random.default_rng(0)
    img0, img1 = (rng.integers(0, 256, (2, 124, 190, 3), dtype=np.uint8) for _ in range(2))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        runner = FlowRunner("raft", weights, device=cuda, iters=iters)
        got, one = runner.batch(img0, img1), runner(img0[1], img1[1])
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = flags
    with torch.no_grad():
        want = raft_reference.raft(weights, img0, img1, iters).numpy()
    err = max(np.abs(got - want).max(), np.abs(one - want[1]).max())
    print(f"raft on the card, {iters} updates: max |difference| {err:.3g} px")
    assert got.shape == want.shape == (2, 124, 190, 2) and err <= RAFT_CARD_TOLERANCE[iters]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runner_stages_uint8_frames_and_matches_float_frames(cuda, cudnn_deterministic, dtype):
    """On the card, uint8 frames cross as uint8 through the runner's pinned
    staging buffer (one ``u8_uploads`` a call, ``batch`` or ``__call__``) and
    give the flow of the same frames passed as float32, bit for bit; float32,
    float64 and uint16 frames take the host's conversion (no ``u8_uploads``).
    At 64x576 the head runs on K3."""
    params = init_params("flownet2", seed=0)
    rng = np.random.default_rng(5)
    u0, u1 = (rng.integers(0, 256, (2, 64, 576, 3), dtype=np.uint8) for _ in range(2))
    runner = FlowRunner("flownet2", params, device=cuda, dtype=dtype)
    uploads = FlowRunner.u8_uploads
    want = runner.batch(u0.astype(np.float32), u1.astype(np.float32))
    want1 = runner(u0[1].astype(np.float32), u1[1].astype(np.float32))
    for other in (np.float64, np.uint16):
        np.testing.assert_array_equal(runner.batch(u0.astype(other), u1.astype(other)), want)
    assert FlowRunner.u8_uploads == uploads and runner._staging == (None, None)
    np.testing.assert_array_equal(runner.batch(u0, u1), want)
    np.testing.assert_array_equal(runner(u0[1], u1[1]), want1)
    assert FlowRunner.u8_uploads == uploads + 2


def test_runner_staging_buffer_is_reused_grown_and_never_stale(cuda, cudnn_deterministic):
    """The pinned buffer is allocated once at a shape and kept for a batch
    that fits, grown for a larger batch; back-to-back calls on other frames
    each return their own frames' flow (the float32-frame path's)."""
    params = init_params("flownet2-cs", seed=1)
    runner = FlowRunner("flownet2-cs", params, device=cuda)
    rng = np.random.default_rng(8)
    a, b, large = ([rng.integers(0, 256, (n, 64, 128, 3), dtype=np.uint8) for _ in range(2)] for n in (2, 2, 3))
    want_a, want_b, want_large = (runner.batch(*(f.astype(np.float32) for f in p)) for p in (a, b, large))

    np.testing.assert_array_equal(runner.batch(*a), want_a)
    buf = runner._staging[0]
    assert buf.is_pinned() and buf.numel() == 2 * a[0].size
    np.testing.assert_array_equal(runner.batch(*b), want_b)
    assert runner._staging[0].data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(runner.batch(*large), want_large)
    grown = runner._staging[0]
    assert grown.is_pinned() and grown.numel() == 2 * large[0].size
    np.testing.assert_array_equal(runner.batch(*a), want_a)
    assert runner._staging[0].data_ptr() == grown.data_ptr()


def test_runner_uint8_staging_opens_the_four_phases_once(cuda):
    """The staged path opens ``fn2.runner.prepare``, ``upload``, ``forward``
    and ``download`` once each, in order (the benchmark's span readers
    count on one of each a request)."""
    from torch.profiler import ProfilerActivity, profile

    runner = FlowRunner("flownets", init_params("flownets", seed=2), device=cuda)
    rng = np.random.default_rng(9)
    u0, u1 = (rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8) for _ in range(2))
    runner.batch(u0, u1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.batch(u0, u1)
    phases = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith("fn2.runner."))
    assert [name for _, _, name in phases] == [f"fn2.runner.{p}" for p in ("prepare", "upload", "forward", "download")]
    assert all(end <= start for (_, end, _), (start, _, _) in zip(phases, phases[1:]))


# -- the 1-D (stereo) correlation ------------------------------------------------

# C, H, W, max_displacement, stride2, single_direction. Both kernels stage
# whole rows up to their thread and shared-memory limits and tile the
# columns past them (the forward at 320 columns and gw 81, the backward at
# 320 in float32); W below md (33 at md 40), odd (57), not a multiple of 4
# (70, 130, 50: scalar stores, unaligned rows), C not a multiple of the
# chunks (100, 99, 20, 8) and odd in bfloat16 (99), stride2 1, 2 and 3 (the
# kernels' general-stride path).
CORR1D_CASES = [
    (128, 3, 240, 40, 1, -1), (128, 2, 128, 40, 1, -1), (64, 3, 84, 40, 1, -1), (64, 3, 33, 40, 1, -1),
    (100, 4, 100, 40, 1, 0), (99, 3, 57, 4, 1, 1), (32, 3, 70, 40, 2, -1), (20, 2, 130, 20, 2, 1),
    (8, 2, 300, 4, 2, 0), (256, 2, 64, 40, 1, 1), (128, 2, 320, 40, 1, 0), (16, 2, 50, 9, 3, 0),
]
CORR1D_DTYPE_CASES = [(*case, dtype, rel) for case in CORR1D_CASES for dtype, rel in DTYPE_TOLS]


def _corr1d_kw(md, s2, sd):
    return dict(max_displacement=md, kernel_size=1, stride1=1, stride2=s2, pad=md, single_direction=sd)


def _corr1d_inputs(device, dtype, n, c, h, w, md, s2, sd, seed):
    """f1, f2 (N, C, H, W) and a cotangent (N, gw, H, W), seeded."""
    g0 = torch.Generator().manual_seed(seed)
    gw = md // s2 + 1 if sd else 2 * (md // s2) + 1
    f1, f2 = (torch.randn(n, c, h, w, generator=g0).to(device, dtype) for _ in range(2))
    return f1, f2, torch.randn(n, gw, h, w, generator=g0).to(device, dtype)


@pytest.mark.parametrize("c,h,w,md,s2,sd,dtype,rel", CORR1D_DTYPE_CASES)
def test_correlation_1d_kernel_matches_plain(cuda, c, h, w, md, s2, sd, dtype, rel):
    """The 1-D forward through correlation_1d on NCHW maps (one launch)
    against correlation_1d_plain on the card, every single_direction,
    stride2 1, 2 and 3, channel counts that are not a multiple of the 16
    (f32) or 32 (bf16) channel chunks: f32 within 1e-5 * max|ref| (sums in
    another order), bf16 within 2e-2 * max|ref| (one bf16 rounding of the
    output)."""
    f1, f2, _ = _corr1d_inputs(cuda, dtype, 2, c, h, w, md, s2, sd, seed=c + w + md)
    kw = _corr1d_kw(md, s2, sd)
    before = correlation_1d_cuda.launches
    got = correlation_1d(f1, f2, **kw)
    torch.cuda.synchronize()
    assert correlation_1d_cuda.launches == before + 1
    ref = correlation_1d_plain(f1, f2, **kw)
    assert got.shape == ref.shape and got.dtype == dtype
    _rel_close(got, ref, rel)


@pytest.mark.parametrize("c,h,w,md,s2,sd,dtype,rel", CORR1D_DTYPE_CASES)
def test_correlation_1d_backward_kernel_matches_plain(cuda, c, h, w, md, s2, sd, dtype, rel):
    """Gradients through correlation_1d on the card (one launch of the
    backward kernel for df1 and df2, NCHW in and out) against
    correlation_1d_backward_plain, on the forward's cases and tolerances
    (channel counts that are not a multiple of the 32 (f32) or 64 (bf16)
    channel chunks: 100, 99, 20, 8)."""
    f1, f2, grad = _corr1d_inputs(cuda, dtype, 2, c, h, w, md, s2, sd, seed=c + w + md + 1)
    kw = _corr1d_kw(md, s2, sd)
    a, b = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
    before = correlation_1d_backward_cuda.launches
    got = torch.autograd.grad(correlation_1d(a, b, **kw), (a, b), grad)
    torch.cuda.synchronize()
    assert correlation_1d_backward_cuda.launches == before + 1
    ref = correlation_1d_backward_plain(f1, f2, grad, **kw)
    for x, y in zip(got, ref):
        assert x.shape == y.shape == (2, c, h, w) and x.dtype == dtype
        _rel_close(x, y, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", ["f1", "f2"])
def test_correlation_1d_backward_kernel_one_sided(cuda, need, dtype):
    """need_f1 only or need_f2 only: one launch, the other gradient None, and
    the one asked for equal to the same gradient of the two-sided call."""
    f1, f2, grad = _corr1d_inputs(cuda, dtype, 2, 128, 3, 100, 40, 1, -1, seed=9)
    kw = dict(max_displacement=40, stride2=1, single_direction=-1)
    both = correlation_1d_backward_cuda(f1, f2, grad, **kw)
    before = correlation_1d_backward_cuda.launches
    got = correlation_1d_backward_cuda(f1, f2, grad, **kw, need_f1=need == "f1", need_f2=need == "f2")
    torch.cuda.synchronize()
    assert correlation_1d_backward_cuda.launches == before + 1
    k = 0 if need == "f1" else 1
    assert got[1 - k] is None
    assert torch.equal(got[k], both[k])
    _rel_close(got[k], correlation_1d_backward_plain(f1, f2, grad, **_corr1d_kw(40, 1, -1))[k],
               1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype,offset,c,w", [
    (torch.float32, 1, 64, 40), (torch.float32, 3, 7, 41), (torch.bfloat16, 1, 64, 40), (torch.bfloat16, 1, 7, 41),
])
def test_correlation_1d_kernels_at_a_storage_offset(cuda, dtype, offset, c, w):
    """NCHW maps that start `offset` elements into their allocation: no row
    is 16-byte aligned, so the kernels take their narrower copies; in
    bfloat16 an odd offset puts every row's first column (and, at W 41,
    every other row's) on an odd element, which no cp.async copy can move.
    Forward and both gradients within 1e-5 (f32) or 2e-2 (bf16) x max|ref|
    of the plain versions."""
    g0 = torch.Generator().manual_seed(10 + c)
    numel = 2 * c * 3 * w
    buf = torch.randn(2 * numel + offset, generator=g0).to(cuda, dtype)
    f1 = buf[offset:offset + numel].view(2, c, 3, w)
    f2 = buf[offset + numel:offset + 2 * numel].view(2, c, 3, w)
    assert f1.is_contiguous() and f1.storage_offset() == offset
    grad = torch.randn(2, 41, 3, w, generator=g0).to(cuda, dtype)
    kw = dict(max_displacement=40, stride2=1, single_direction=-1)
    out = correlation_1d_cuda(f1, f2, **kw)
    df1, df2 = correlation_1d_backward_cuda(f1, f2, grad, **kw)
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    _rel_close(out, correlation_1d_plain(f1, f2, **_corr1d_kw(40, 1, -1)), rel)
    ref1, ref2 = correlation_1d_backward_plain(f1, f2, grad, **_corr1d_kw(40, 1, -1))
    _rel_close(df1, ref1, rel)
    _rel_close(df2, ref2, rel)


def test_correlation_1d_wrappers_raise_on_what_they_do_not_take(cuda):
    before = correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches
    f = torch.zeros(1, 8, 6, 50, device=cuda)
    with pytest.raises(TypeError):
        correlation_1d(f.half(), f.half(), max_displacement=4, pad=4)
    with pytest.raises(ValueError, match="devices"):
        correlation_1d(f, f.cpu(), max_displacement=4, pad=2)
    kw = dict(max_displacement=4, stride2=1, single_direction=-1)
    nchw = torch.zeros(1, 8, 6, 9, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_1d_cuda(nchw.transpose(2, 3).contiguous().transpose(2, 3), nchw, **kw)
    with pytest.raises(ValueError, match="grad shape"):
        correlation_1d_backward_cuda(nchw, nchw, torch.zeros(1, 9, 6, 9, device=cuda), **kw)
    with pytest.raises(TypeError):
        correlation_1d_backward_cuda(nchw, nchw, torch.zeros(1, 5, 6, 9, device=cuda, dtype=torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_1d_cuda(nchw, nchw.cpu(), **kw)
    tall = torch.zeros(1, 1, 1, 1, device=cuda).expand(2**15, 1, 2**15, 1)  # N*H = 2**30: 32-bit work items
    with pytest.raises(ValueError, match="2\\*\\*30"):
        correlation_1d_cuda(tall, tall, **kw)
    assert (correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches) == before


def test_correlation_1d_runs_one_device_kernel_each_way(cuda):
    """On contiguous NCHW maps, one correlation_1d forward and its backward
    (both gradients) each run exactly one device kernel: no layout copy,
    no transpose, no cast (under torch.profiler's CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    f1, f2, grad = _corr1d_inputs(cuda, torch.float32, 2, 128, 4, 240, 40, 1, -1, seed=12)
    a, b = f1.requires_grad_(True), f2.requires_grad_(True)
    kw = _corr1d_kw(40, 1, -1)
    out = correlation_1d(a, b, **kw)  # warm-up: the build and the first launch
    torch.autograd.grad(out, (a, b), grad)
    torch.cuda.synchronize()

    def device_kernels(prof):
        return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        out = correlation_1d(a, b, **kw)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        torch.autograd.grad(out, (a, b), grad)
        torch.cuda.synchronize()
    fwd_names, bwd_names = device_kernels(fwd), device_kernels(bwd)
    assert len(fwd_names) == 1 and "correlation1d_kernel" in fwd_names[0], fwd_names
    assert len(bwd_names) == 1 and "correlation1d_backward_kernel" in bwd_names[0], bwd_names


# Configurations outside the kernels' (multiply, k 1, stride1 1, pad ==
# md), as tests/test_torch_ops.py's GENERAL_CONFIGS: the plain versions on
# the card, held to the CPU
GENERAL_CONFIGS = {
    "k3": dict(max_displacement=4, kernel_size=3, stride1=1, stride2=1, pad=5),
    "stride1-2": dict(max_displacement=4, kernel_size=1, stride1=2, stride2=2, pad=4),
    "subtract": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=1, pad=4, multiply=False),
    "pad-below-md": dict(max_displacement=4, kernel_size=1, stride1=1, stride2=2, pad=2),
}


@pytest.mark.parametrize("dims", ["2d", "1d"])
@pytest.mark.parametrize("case", sorted(GENERAL_CONFIGS))
def test_correlation_general_configs_on_card_match_cpu(cuda, case, dims):
    """correlation and correlation_1d on the card in a configuration no
    kernel takes: no kernel launch, and the output and both gradients
    within 1e-5 x max|ref| of the same call on the CPU (float32 sums in
    another order)."""
    kw = dict(GENERAL_CONFIGS[case])
    if dims == "1d":
        kw["single_direction"] = {"k3": 0, "stride1-2": -1, "subtract": 1, "pad-below-md": 0}[case]
    port = correlation if dims == "2d" else correlation_1d
    g0 = torch.Generator().manual_seed(13)
    f1, f2 = (torch.randn(2, 6, 9, 17, generator=g0) for _ in range(2))
    kernels = (correlation_cuda, correlation_backward_cuda, correlation_1d_cuda, correlation_1d_backward_cuda)
    before = [k.launches for k in kernels]
    results = []
    for dev in (cuda, "cpu"):
        a, b = f1.to(dev).requires_grad_(True), f2.to(dev).requires_grad_(True)
        out = port(a, b, **kw)
        grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(14)).to(dev)
        results.append((out.detach(), *torch.autograd.grad(out, (a, b), grad)))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    for got, ref in zip(*results):
        assert got.device.type == "cuda" and got.shape == ref.shape
        _rel_close(got, ref, 1e-5)


def test_dispnetc_on_card_launches_the_1d_kernel_once_and_matches_cpu(cuda, no_tf32):
    """One float32 DispNetC FlowRunner batch on the card launches the 1-D
    forward once and no other kernel, and matches the same port on the CPU
    to mean EPE <= 1e-2 px (both output channels)."""
    params = init_params("dispnetc", seed=0)
    rng = np.random.default_rng(1)
    i0, i1 = (rng.uniform(0, 255, (2, 70, 130, 3)).astype(np.float32) for _ in range(2))
    runner = FlowRunner("dispnetc", params, device=cuda)
    others = (flow_warp_cuda, correlation_cuda, head_conv2d_cuda, head_deconv2d_cuda, fusion_head_cuda)
    before = correlation_1d_cuda.launches, [k.launches for k in others]
    got = runner.batch(i0, i1)
    assert correlation_1d_cuda.launches - before[0] == 1
    assert [k.launches for k in others] == before[1]
    ref = FlowRunner("dispnetc", params, device="cpu").batch(i0, i1)
    assert got.shape == ref.shape == (2, 70, 130, 2)
    assert float(np.sqrt(((got - ref) ** 2).sum(-1)).mean()) <= 1e-2


def test_dispnetc_train_step_on_card_matches_cpu(cuda):
    """One float32 DispNetC loss and gradient on the card (TF32 off, cuDNN's
    deterministic algorithms) against the port on the CPU: one launch each
    of the 1-D forward and backward; loss rtol 1e-4, the gradients' relative
    L2 over all tensors and of the median tensor <= 1e-3."""
    flat = init_params("dispnetc", seed=3)
    batch = _smooth_batch(n=2, seed=14)
    batch["flow"] = np.ascontiguousarray(batch["flow"][..., :1])

    def loss_and_grads(device):
        with torch.device("meta"):
            net = DispNetC()
        net = load_into(net, flat).to(device)
        loss, _ = objectives.LOSSES["dispnetc"](net, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in net.named_parameters()}

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic = True
    try:
        before = correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches
        loss, grads = loss_and_grads(cuda)
        assert (correlation_1d_cuda.launches - before[0], correlation_1d_backward_cuda.launches - before[1]) == (1, 1)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = flags
    ref_loss, ref_grads = loss_and_grads("cpu")
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    whole, median = _grad_errors(grads, ref_grads)
    assert whole <= 1e-3 and median <= 1e-3, f"relative L2 of all {whole:.3g}, median {median:.3g}"


# -- the packed formats and Caffe weights on the card ------------------------------------------------


def test_transport_flow_decodes_on_the_card_as_on_the_cpu(cuda):
    """int16 transport flow decoded on the card: value/32, SHRT_MAX as NaN,
    equal to the CPU's decode bit for bit."""
    from flownet2_tpu_torch.core.codec import flow_as_f32

    rng = np.random.default_rng(15)
    enc = rng.integers(-32768, 32768, (4, 96, 128, 2)).astype(np.int16)
    enc[0, :4, :4] = 32767
    got = flow_as_f32(torch.from_numpy(enc).to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(), flow_as_f32(torch.from_numpy(enc)).numpy())
    assert got[0, :4, :4].isnan().all() and not got[1].isnan().any()


def test_run_flownet_on_card_from_a_caffemodel_matches_the_npz(cuda, no_tf32, tmp_path):
    """FlowNet2 through run_flownet on cuda:0, its weights once as a merged
    .caffemodel and once as an .npz: the same .flo, bit for bit (cuDNN's
    deterministic algorithms)."""
    from flownet2_tpu_torch.checkpoint import save_params
    from flownet2_tpu_torch.cli.run_flownet import main as run_flownet
    from flownet2_tpu_torch.core.flow_io import read_flo, write_ppm
    from flownet2_tpu_torch.models.export_caffe import export_caffemodel_merged

    flat = init_params("flownet2", seed=16)
    tree: dict = {}
    for key, v in flat.items():
        sub, layer, leaf = key.split("/")
        tree.setdefault(sub, {}).setdefault(layer, {})[leaf] = v
    export_caffemodel_merged(tree, str(tmp_path / "w.caffemodel"))
    save_params(str(tmp_path / "w.npz"), flat)
    rng = np.random.default_rng(16)
    pair = []
    for i in range(2):
        pair.append(str(tmp_path / f"img{i}.ppm"))
        write_ppm(pair[-1], rng.integers(0, 256, (130, 200, 3), dtype=np.uint8))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("w.caffemodel", "w.npz"):
            out = str(tmp_path / f"{name}.flo")
            assert run_flownet([str(tmp_path / name), "flownet2", *pair, out, "--gpu", "0"]) == 0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = read_flo(tmp_path / "w.caffemodel.flo"), read_flo(tmp_path / "w.npz.flo")
    assert a.shape == (130, 200, 2) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_train_cli_dispnetc_step_from_disparity_records(cuda, tmp_path):
    """One cli.train step of DispNetC on the card from a disparity .flowrec:
    one launch each of the 1-D forward and backward, a finite loss, a
    snapshot."""
    from flownet2_tpu_torch.cli.train import main as train_main
    from flownet2_tpu_torch.data import FlowRecordWriter

    rng = np.random.default_rng(17)
    rec = str(tmp_path / "disp.flowrec")
    with FlowRecordWriter(rec) as w:
        for _ in range(2):
            img = rng.integers(0, 256, (130, 260, 3), dtype=np.uint8)
            w.write(img, np.roll(img, -5, axis=1), np.full((130, 260), -5.0, np.float32))
    before = correlation_1d_cuda.launches, correlation_1d_backward_cuda.launches
    assert train_main(["--model", "dispnetc", "--dataset", "flowrec", "--data-root", rec, "--no-augment",
                       "--batch", "2", "--crop", "128x256", "--max-iter", "1", "--gpu", "0",
                       "--snapshot-dir", str(tmp_path / "snaps")]) == 0
    assert (correlation_1d_cuda.launches - before[0], correlation_1d_backward_cuda.launches - before[1]) == (1, 1)
    with np.load(tmp_path / "snaps" / "iter_0000001.npz") as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)


@pytest.mark.parametrize("crop", [(64, 96), (80, 160)], ids=["inside the source", "wider than the source"])
def test_augmentation_on_card_matches_cpu_and_runs_on_k1(cuda, crop):
    """The augmented batch (noise 0) on the card against the CPU: images
    within 1e-3 on the 0-255 scale, flow equal with its NaN pattern; the
    affine sample launches K1 once a frame, and nothing records K2."""
    from flownet2_tpu_torch.data.augment_pipeline import (
        FlowNetAugConfig,
        apply_augmentation_device,
        sample_aug_arrays,
    )

    rng = np.random.default_rng(18)
    n, sh, sw = 2, 72, 128
    batch = {"img0": rng.integers(0, 256, (n, sh, sw, 3), dtype=np.uint8),
             "img1": rng.integers(0, 256, (n, sh, sw, 3), dtype=np.uint8),
             "flow": rng.normal(0, 3, (n, sh, sw, 2)).astype(np.float32)}
    batch["flow"][0, :, :, 1] = np.nan
    batch.update(sample_aug_arrays(FlowNetAugConfig(), rng, n, sh, sw, *crop))
    batch["aug_noise"] = np.zeros(n, np.float32)

    def run(device):
        on = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        with torch.no_grad():
            return apply_augmentation_device(on, torch.Generator(device=device).manual_seed(0), *crop)

    before = flow_warp_cuda.launches, flow_warp_backward_cuda.launches
    got = run(cuda)
    torch.cuda.synchronize()
    assert (flow_warp_cuda.launches - before[0], flow_warp_backward_cuda.launches - before[1]) == (2, 0)
    ref = run("cpu")
    for k in ("img0", "img1"):
        assert got[k].shape == (n, 3, *crop)
        assert (got[k].cpu() - ref[k]).abs().max().item() <= 1e-3
    flow, ref_flow = got["flow"].cpu(), ref["flow"]
    assert torch.equal(flow.isnan(), ref_flow.isnan()) and ref_flow.isnan().any()
    assert torch.equal(flow.nan_to_num(0.0), ref_flow.nan_to_num(0.0))


@pytest.mark.parametrize("transform", ["black", "eigen", "shadow"])
def test_pixel_transforms_on_card_match_cpu(cuda, transform):
    """Black, chromatic-eigen and shadow on the card against the CPU, on
    8-bit pixel values in [0, 1]: black and shadow within 1e-6 with the
    same NaN pattern, eigen (pow, trigonometry and a batch mean, each
    rounded by the card's own routines) within 1e-5."""
    from flownet2_tpu_torch.ops.augment import apply_black_augmentation, apply_chromatic_eigen_transform, apply_shadow

    rng = np.random.default_rng(19)
    n, h, w = 3, 48, 64
    imgs = (rng.integers(0, 256, (n, 3, h, w)) / 256).astype(np.float32)
    flows = rng.normal(0, 3, (n, 2, h, w)).astype(np.float32)
    flows[0, :, 5:12, 8:20] = np.nan
    ang, dist = rng.uniform(-3, 3, n), rng.uniform(-20, 20, n)
    eigen = {k: rng.uniform(0.7, 1.3, (n, 3)) for k in ("pow_nomean", "mult_nomean", "pow_withmean", "mult_withmean")}
    eigen.update({k: rng.uniform(-0.1, 0.1, (n, 3)) for k in ("add_nomean", "add_withmean")})
    eigen.update(lmult_pow=rng.uniform(0.8, 1.2, n), lmult_add=rng.uniform(-0.1, 0.1, n),
                 lmult_mult=rng.uniform(0.8, 1.2, n), col_angle=rng.uniform(-0.5, 0.5, n))

    def run(device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        if transform == "black":
            return apply_black_augmentation(t(imgs), t(flows), t([0.0, 1.0, 0.0]), t([0.15, 0.0, 0.3]))
        if transform == "eigen":
            return (apply_chromatic_eigen_transform(t(imgs), {k: t(v) for k, v in eigen.items()}),)
        return (apply_shadow(t(imgs), t(np.cos(ang)), t(np.sin(ang)), t(dist), t([0.2, 0.4, 0.3])),)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = run(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = run("cpu")
    for g, r in zip(got, ref):
        g = g.cpu()
        assert g.shape == r.shape and torch.equal(g.isnan(), r.isnan())
        err = (g - r).nan_to_num(0.0).abs().max().item()
        assert err <= (1e-5 if transform == "eigen" else 1e-6), err
    if transform == "black":
        assert ref[1].isnan().any() and (ref[0][1] == 0).all()


def _cli_output(main, argv) -> tuple[int, str]:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_test_on_card_matches_cpu_per_batch(cuda, no_tf32, tmp_path):
    """cli.test --model flownet2 (f32, one .npz) on the card and on the CPU
    over a synthetic split at 128x192 (adapted to 128x192): every batch's
    EPE within 1e-3 px; the card's run launches 4 K1 and 1 correlation a
    forward."""
    from flownet2_tpu_torch.checkpoint import save_params
    from flownet2_tpu_torch.cli import test as test_cli
    from flownet2_tpu_torch.tools.synth_dataset import write_split

    rec = str(tmp_path / "eval.flowrec")
    write_split(rec, 4, 3, 128, 192, log=lambda *_: None, max_shift=5.0, n_layers=2)
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params("flownet2", seed=6))
    argv = ["--weights", npz, "--model", "flownet2", "--dataset", "flowrec", "--data-root", rec, "--batch", "2"]
    flow_warp_cuda.launches = correlation_cuda.launches = 0
    rc, card = _cli_output(test_cli.main, argv + ["--gpu", "0"])
    assert rc == 0 and (flow_warp_cuda.launches, correlation_cuda.launches) == (8, 2)
    rc, cpu = _cli_output(test_cli.main, argv + ["--device", "cpu"])
    assert rc == 0

    def epes(out):
        return [float(line.rsplit("=", 1)[1]) for line in out.splitlines() if line.startswith("Batch ")]

    assert len(epes(card)) == 2
    np.testing.assert_allclose(epes(card), epes(cpu), atol=1e-3)


def test_time_cmd_breakdown_on_card_has_the_cpu_walks_stages(cuda):
    """time_cmd --breakdown on the card at 128x192 b2: one row per stage of
    the CPU walk with its count, finite times, and the walk on the card
    equal to the walk on the CPU (names, counts, shapes)."""
    from flownet2_tpu_torch.cli import time_cmd
    from flownet2_tpu_torch.tools.breakdown import walk_stages

    net = load_into(FlowNet2(), init_params("flownet2", seed=0))
    img = torch.zeros(2, 3, 128, 192)
    cpu = [(st.name, st.count, st.spatial()) for st in walk_stages("flownet2", net, img, img)]
    net = net.to(cuda)
    card = [(st.name, st.count, st.spatial()) for st in walk_stages("flownet2", net, img.to(cuda), img.to(cuda))]
    assert card == cpu
    rc, out = _cli_output(time_cmd.main, ["--model", "flownet2", "--height", "128", "--width", "192", "--batch", "2",
                                          "--iterations", "2", "--breakdown", "--backward", "--gpu", "0"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("forward: ") and lines[1].startswith("forward+backward: ")
    rows = [line.split() for line in lines[3:-1]]
    assert [(r[0], int(r[2])) for r in rows] == [(name, count) for name, count, _ in cpu]
    assert all(np.isfinite(float(r[3])) and float(r[3]) > 0 for r in rows)
    assert lines[-1].startswith("sum (count-weighted)")


# -- data-parallel training on the card's one H100 ---------------------------------------------------

DP_ADAM = dict(solver_type="adam", base_lr=1e-4, lr_policy="fixed", momentum=0.9, momentum2=0.999)


def _dp_run(device, group=None, rows=None, steps=2, iter_size=1):
    """FlowNetC Adam steps on smooth 320x448 batches of 4 (this rank's rows
    of them in a group; ``iter_size`` micro-batches of consecutive rows):
    the losses, the launches of the warp, correlation and correlation
    backward kernels, the first step's gradients and the parameters after
    (numpy: they cross process boundaries)."""
    from flownet2_tpu_torch.parallel import rank_rows
    from flownet2_tpu_torch.train import Solver, SolverConfig

    with torch.device("meta"):
        net = FlowNetC()
    solver = Solver(SolverConfig(**DP_ADAM, iter_size=iter_size), objectives.flownet_c_loss,
                    load_into(net, init_params("flownetc", seed=4)), device=device, group=group)
    kernels = (flow_warp_cuda, correlation_cuda, correlation_backward_cuda)
    before = [k.launches for k in kernels]
    losses = []
    for i in range(steps):
        batch = _smooth_batch(n=4, h=320, w=448, seed=30 + i)
        batch = batch if rows is None else rank_rows(batch, *rows)
        if iter_size > 1:
            batch = {k: v.reshape(iter_size, -1, *v.shape[1:]) for k, v in batch.items()}
        losses.append(solver.step(batch)[0].item())
        if i == 0:
            grads = {k: p.grad.cpu().numpy().copy() for k, p in solver.net.named_parameters()}
    torch.cuda.synchronize()
    params = {k: p.detach().cpu().numpy() for k, p in solver.net.named_parameters()}
    return losses, tuple(k.launches - b for k, b in zip(kernels, before)), grads, params


def _dp_gloo_rank(group):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    losses, launches, grads, params = _dp_run(group.device, group, rows=(group.rank, group.world))
    return losses, launches, (grads, params) if group.is_main else None


def test_dp_world_one_over_nccl_equals_the_plain_step(cuda, no_tf32):
    """A Solver in a world-1 NCCL group takes the plain Solver's steps:
    parameters equal to within the spread of two plain runs (0 with
    cuDNN's deterministic algorithms), the same kernel launches."""
    import torch.distributed as dist

    from flownet2_tpu_torch.parallel import init_group
    from flownet2_tpu_torch.parallel.mesh import free_address

    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = [_dp_run(cuda) for _ in range(2)]
        group = init_group(0, 1, torch.device("cuda", 0), free_address(), backend="nccl")
        try:
            grouped = _dp_run(group.device, group)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = flag
    spread = max(float(np.abs(plain[0][3][k] - plain[1][3][k]).max()) for k in plain[0][3])
    diff = max(float(np.abs(grouped[3][k] - plain[0][3][k]).max()) for k in plain[0][3])
    assert diff <= spread, (diff, spread)
    assert grouped[1] == plain[0][1] == (0, 2, 2)
    assert grouped[0] == plain[0][0]


def test_dp_two_gloo_ranks_on_one_card_match_one_process(cuda, no_tf32):
    """2 processes over gloo sharing cuda:0, 2 pairs each, against one
    process, cuDNN's deterministic algorithms throughout: loss rtol 1e-4 and the first step's gradients (relative L2 of
    all tensors and of the median tensor <= 1e-3) against the process at
    b4; the updates (the same limits) against the process at iter_size 2
    on the ranks' halves, since Adam turns b4's rounding against 2 x b2
    into a larger share of an update; each rank's launches the one
    process's."""
    from flownet2_tpu_torch.parallel import spawn

    ranks = spawn(_dp_gloo_rank, [torch.device("cuda", 0)] * 2, backend="gloo", join_timeout=300)
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses, launches, grads, params = _dp_run(cuda)
        *_, halves = _dp_run(cuda, iter_size=2)
    finally:
        torch.backends.cudnn.deterministic = flag
    with torch.device("meta"):
        net = FlowNetC()
    start = {k: p.detach().numpy() for k, p in load_into(net, init_params("flownetc", seed=4)).named_parameters()}
    np.testing.assert_allclose(ranks[0][0], losses, rtol=1e-4)
    assert ranks[0][1] == ranks[1][1] == launches
    got_grads, got_params = ranks[0][2]
    whole, median = _grad_errors({k: torch.from_numpy(v) for k, v in got_grads.items()},
                                 {k: torch.from_numpy(v) for k, v in grads.items()})
    assert whole <= 1e-3 and median <= 1e-3, ("gradients", whole, median)
    whole, median = _grad_errors({k: torch.from_numpy(got_params[k] - start[k]) for k in start},
                                 {k: torch.from_numpy(halves[k] - start[k]) for k in start})
    assert whole <= 1e-3 and median <= 1e-3, ("updates", whole, median)


def _prefetch_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"img0": rng.integers(0, 256, (4, 96, 128, 3), dtype=np.uint8),
             "flow": rng.integers(-32768, 32767, (4, 96, 128, 2), dtype=np.int16),
             "aug_mat0": rng.normal(size=(4, 6)).astype(np.float32), "label": np.arange(4, dtype=np.int32)}
            for _ in range(n)]


def test_prefetcher_on_card_equals_the_direct_upload_without_a_host_sync(cuda):
    """Batches staged through pinned blocks on the prefetcher's stream equal
    ``torch.as_tensor(v).to(card)`` (max abs 0), and taking them and
    working on them waits for nothing on the host (sync debug mode
    "error"); the staging thread ends when the generator is closed."""
    import threading

    from flownet2_tpu_torch.data import DevicePrefetcher

    batches = _prefetch_batches(8)
    DevicePrefetcher.uploads = 0
    gen = iter(DevicePrefetcher(iter(batches), depth=2, device=cuda))
    first = next(gen)
    got = [first]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in gen:
            b["img0"].float().mul_(2)  # queued work on the current stream
            got.append(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert DevicePrefetcher.uploads == 8 and len(got) == 8
    for b, src in zip(got, batches):
        for k, v in src.items():
            ref = torch.as_tensor(v).to(cuda)
            assert b[k].device.type == "cuda" and b[k].dtype == ref.dtype and b[k].shape == ref.shape
            assert torch.equal(b[k], ref)
    gen.close()
    for t in [t for t in threading.enumerate() if t.name == "DevicePrefetcher"]:
        t.join(5)
        assert not t.is_alive()


def test_prefetcher_with_no_device_named_stages_on_the_current_card(cuda):
    from flownet2_tpu_torch.data import DevicePrefetcher

    p = DevicePrefetcher(iter(_prefetch_batches(1)))
    assert p.device == torch.device("cuda", torch.cuda.current_device())
    (b,) = list(p)
    assert b["img0"].is_cuda


@pytest.mark.parametrize("transposed", [False, True], ids=["conv 3x3", "deconv k4 s2"])
def test_bf16_pass_conv_on_card_matches_cpu(cuda, transposed):
    """tools/diag/tpu_arith's bfloat16-pass conv and deconv, forward and
    both operand gradients, on the card with cuDNN's TF32 off against the
    CPU: both sum exact products of bf16 values in float32, so they differ
    by the order of the sums alone, within 2 n 2^-24 of the terms'
    magnitudes (n terms a sum)."""
    from torch import nn

    from flownet2_tpu_torch.tools.diag.tpu_arith import BF16PassConv

    torch.manual_seed(9)
    layer = nn.ConvTranspose2d(16, 8, 4, stride=2, padding=1) if transposed else nn.Conv2d(16, 24, 3, padding=1)
    geometry = (layer.stride, layer.padding, layer.dilation, transposed, (0, 0), 1)
    x = torch.randn(2, 16, 40, 56)
    g = torch.randn(2, layer.out_channels, *((80, 112) if transposed else (40, 56)))

    def run(device, xx, ww, gg, op=lambda *a: BF16PassConv.apply(*a, geometry)):
        xx, ww = (t.detach().to(device).requires_grad_() for t in (xx, ww))
        out = op(xx, ww, None)
        out.backward(gg.to(device))
        return [t.detach().cpu().double() for t in (out, xx.grad, ww.grad)]

    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = run(cuda, x, layer.weight.detach(), g)
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    ref = run("cpu", x, layer.weight.detach(), g)
    bf = [t.bfloat16().double() for t in (x, layer.weight.detach(), g)]
    mags = run("cpu", *[t.abs() for t in bf], op=lambda a, b, _: torch.ops.aten.convolution(a, b, None, *geometry))
    terms = (layer.in_channels * 16 if transposed else 16 * 9, layer.out_channels * (16 if transposed else 9),
             2 * g.shape[2] * g.shape[3])
    for got_, ref_, mag, n in zip(got, ref, mags, terms):
        assert ((got_ - ref_).abs() <= 2 * n * 2.0 ** -24 * mag + 1e-30).all()
