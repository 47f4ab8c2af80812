"""The PyTorch port's nets, cascade and FlowRunner against the JAX package.

One set of seeded random weights (the port's ``init_params``, in the JAX
layout) goes to both packages: to JAX through
``flownet2_tpu.checkpoint.unflatten_params``, to the port through its
weight bridge. Inputs are numpy arrays from a seed. Everything runs on the
CPU in float32 at 64x128, as tests/test_models.py does; there the JAX
package takes its exact routes (gather warp, plain layouts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params as jax_flatten_params
from flownet2_tpu.checkpoint import load_params as jax_load_params
from flownet2_tpu.checkpoint import save_params as jax_save_params
from flownet2_tpu.checkpoint import unflatten_params
from flownet2_tpu.inference import FlowRunner as JaxFlowRunner
from flownet2_tpu.models import (
    dispnet_c_apply as jax_dispnet_c_apply,
    dispnet_c_init as jax_dispnet_c_init,
    flownet2_apply as jax_flownet2_apply,
    flownet2_cs_apply as jax_flownet2_cs_apply,
    flownet2_css_apply as jax_flownet2_css_apply,
    flownet_c_apply as jax_flownet_c_apply,
    flownet_s_apply as jax_flownet_s_apply,
    flownet_sd_apply as jax_flownet_sd_apply,
    fusion_apply as jax_fusion_apply,
    normalize_images as jax_normalize_images,
)
from flownet2_tpu_torch.checkpoint import (
    init_params,
    load_into,
    load_params,
    params_from_state_dict,
    state_dict_from_params,
)
from flownet2_tpu_torch.inference import FlowRunner
from flownet2_tpu_torch.models import (
    DispNetC,
    FlowNet2,
    dispnet_c_apply,
    flownet2_apply,
    flownet2_cs_apply,
    flownet2_css_apply,
    flownet_c_apply,
    flownet_s_apply,
    flownet_sd_apply,
    fusion_apply,
    normalize_images,
)
from flownet2_tpu_torch.models.common import to_nchw, to_nhwc

torch.set_num_threads(2)  # the suite runs several workers side by side

H, W = 64, 128
RTOL = ATOL = 1e-4  # per net, float32: XLA's and PyTorch's conv sums differ in order


@pytest.fixture(scope="module")
def weights():
    """Flat JAX-layout FlowNet2 weights, the JAX pytree, and the loaded port net."""
    flat = init_params("flownet2", seed=0)
    with torch.device("meta"):
        net = FlowNet2()
    load_into(net, flat).eval()
    return flat, unflatten_params(flat), net


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return tuple(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32) for _ in range(2))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close_flows(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _epe(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


def test_normalize_images_matches_jax(images):
    """atol 1e-6: float32 statistics."""
    i0, i1 = images
    got = normalize_images(to_nchw(_t(i0)), to_nchw(_t(i1)))
    ref = jax_normalize_images(jnp.asarray(i0), jnp.asarray(i1))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_nhwc(g).numpy(), np.asarray(r), atol=1e-6)
    bf = normalize_images(to_nchw(_t(i0)).bfloat16(), to_nchw(_t(i1)).bfloat16())
    assert bf[0].dtype == torch.bfloat16


@torch.no_grad()
def test_flownet_s_matches_jax(weights):
    _, jp, net = weights
    x = np.random.default_rng(1).standard_normal((1, H, W, 12)).astype(np.float32)
    ref = jax.jit(jax_flownet_s_apply)(jp["flownets_1"], jnp.asarray(x))
    got = flownet_s_apply(net.flownets_1, _t(x))
    _close_flows(got, ref)
    assert got["flow6"].shape == (1, H // 64, W // 64, 2)


@torch.no_grad()
def test_flownet_c_matches_jax(weights, images):
    _, jp, net = weights
    x0, x1 = (np.asarray(v) for v in jax_normalize_images(*map(jnp.asarray, images)))
    ref = jax.jit(jax_flownet_c_apply)(jp["flownetc"], jnp.asarray(x0), jnp.asarray(x1))
    _close_flows(flownet_c_apply(net.flownetc, _t(x0), _t(x1)), ref)


@torch.no_grad()
def test_flownet_sd_matches_jax(weights):
    _, jp, net = weights
    x = np.random.default_rng(2).standard_normal((1, H, W, 6)).astype(np.float32)
    ref = jax.jit(jax_flownet_sd_apply)(jp["flownetsd"], jnp.asarray(x))
    _close_flows(flownet_sd_apply(net.flownetsd, _t(x)), ref)


@torch.no_grad()
def test_fusion_matches_jax(weights):
    _, jp, net = weights
    x = np.random.default_rng(3).standard_normal((1, H, W, 11)).astype(np.float32)
    ref = jax.jit(jax_fusion_apply, static_argnames="layout")(jp["fusion"], jnp.asarray(x), layout="plain")
    _close_flows(fusion_apply(net.fusion, _t(x)), ref)


@torch.no_grad()
def test_flownet2_cascade_matches_jax(weights, images):
    """Whole cascade, float32: mean EPE <= 1e-3 px (a warp tap that lands on
    a validity edge may flip; the mean stays far below that)."""
    _, jp, net = weights
    i0, i1 = images
    ref = np.asarray(jax.jit(jax_flownet2_apply)(jp, jnp.asarray(i0), jnp.asarray(i1)))
    got = flownet2_apply(net, _t(i0), _t(i1)).numpy()
    assert got.shape == ref.shape == (1, H, W, 2)
    assert np.isfinite(got).all()
    assert _epe(got, ref) <= 1e-3


@torch.no_grad()
@pytest.mark.parametrize(
    "apply,jax_apply",
    [(flownet2_cs_apply, jax_flownet2_cs_apply), (flownet2_css_apply, jax_flownet2_css_apply)],
    ids=["cs", "css"],
)
def test_flownet2_cs_css_match_jax(weights, images, apply, jax_apply):
    """The shorter cascades, float32: mean EPE <= 1e-3 px."""
    _, jp, net = weights
    i0, i1 = images
    ref = np.asarray(jax.jit(jax_apply)(jp, jnp.asarray(i0), jnp.asarray(i1)))
    assert _epe(apply(net, _t(i0), _t(i1)).numpy(), ref) <= 1e-3


@pytest.fixture(scope="module")
def dispnet_weights(tmp_path_factory):
    """The JAX package's own DispNetC weights (dispnet_c_init), carried
    through the .npz bridge: written by the JAX checkpoint, read by the port's."""
    path = tmp_path_factory.mktemp("dispnet") / "dispnetc.npz"
    jax_save_params(str(path), jax_dispnet_c_init(jax.random.PRNGKey(0)))
    return load_params(path)


@torch.no_grad()
def test_dispnet_c_matches_jax(dispnet_weights):
    """DispNetC against dispnet_c_apply on the same weights and normalized
    inputs, every scale flow6..flow2 (1-channel disparity): atol 1e-4."""
    flat = dispnet_weights
    with torch.device("meta"):
        net = DispNetC()
    load_into(net, flat).eval()
    rng = np.random.default_rng(8)
    x0, x1 = (rng.standard_normal((1, H, W, 3)).astype(np.float32) for _ in range(2))
    ref = jax.jit(jax_dispnet_c_apply)(unflatten_params(flat), jnp.asarray(x0), jnp.asarray(x1))
    got = dispnet_c_apply(net, _t(x0), _t(x1))
    _close_flows(got, ref)
    assert got["flow2"].shape == (1, H // 4, W // 4, 1) and got["flow6"].shape == (1, H // 64, W // 64, 1)


def test_dispnetc_weight_bridge_round_trips(tmp_path, dispnet_weights):
    """The JAX DispNetC weights load into the port's net with every key
    matched (strict), come back unchanged through params_from_state_dict,
    and the port's init_params('dispnetc') has the JAX package's keys and
    shapes; the port's weights written as .npz load in the JAX package."""
    flat = dispnet_weights
    with torch.device("meta"):
        net = DispNetC()
    load_into(net, flat)
    back = params_from_state_dict(net.state_dict())
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    mine = init_params("dispnetc", seed=1)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in flat.items()}
    assert state_dict_from_params(mine).keys() == net.state_dict().keys()
    jax_save_params(str(tmp_path / "mine.npz"), mine)
    reread = jax_flatten_params(jax_load_params(str(tmp_path / "mine.npz")))
    assert all(np.array_equal(np.asarray(reread[k]), mine[k]) for k in mine)


@pytest.mark.parametrize("model", ["flownetc", "flownet2-sd", "flownet2", "dispnetc"])
def test_flow_runner_matches_jax_at_non_divisible_size(model):
    """100x150 adapts to 128x192 and back, with the per-axis rescale:
    mean EPE <= 1e-3 px. dispnetc's 1-channel disparity comes back in both
    channels, scaled by the width's and the height's factor, as the JAX
    runner returns it; the EPE covers both."""
    flat = init_params(model, seed=4)
    rng = np.random.default_rng(5)
    i0, i1 = (rng.uniform(0, 255, (2, 100, 150, 3)).astype(np.float32) for _ in range(2))
    ref = JaxFlowRunner(model, unflatten_params(flat)).batch(i0, i1)
    got = FlowRunner(model, flat, device="cpu").batch(i0, i1)
    assert got.shape == ref.shape == (2, 100, 150, 2) and got.dtype == np.float32
    assert _epe(got, ref) <= 1e-3
    single = FlowRunner(model, flat, device="cpu")(i0[0], i1[0])
    np.testing.assert_allclose(single, got[0], atol=1e-4)


def test_flow_runner_bfloat16_runs(weights):
    """bf16 casts weights and activations; flow comes back float32 and finite.
    (Under random weights bf16 vs f32 divergence is chaotic, not evidence.)"""
    flat, _, _ = weights
    rng = np.random.default_rng(6)
    i0, i1 = (rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(2))
    runner = FlowRunner("flownet2", flat, device="cpu", dtype="bfloat16")
    assert next(runner.net.parameters()).dtype == torch.bfloat16
    flow = runner(i0, i1)
    assert flow.shape == (H, W, 2) and flow.dtype == np.float32 and np.isfinite(flow).all()


def test_flow_runner_rejects_dispnetc_and_unknown():
    """dispnetc, refused until the port had the 1-D correlation, now builds
    and runs: a (H, W, 2) float32 flow, finite. Unknown models, dtypes other
    than float32 and bfloat16, and a missing device are still refused."""
    rng = np.random.default_rng(9)
    i0, i1 = (rng.uniform(0, 255, (40, 70, 3)).astype(np.float32) for _ in range(2))
    flow = FlowRunner("dispnetc", init_params("dispnetc"), device="cpu")(i0, i1)
    assert flow.shape == (40, 70, 2) and flow.dtype == np.float32 and np.isfinite(flow).all()
    with pytest.raises(ValueError):
        FlowRunner("flownet3", {}, device="cpu")
    with pytest.raises(ValueError):
        FlowRunner("flownets", init_params("flownets"), device="cpu", dtype="float16")
    with pytest.raises(TypeError, match="device"):
        FlowRunner("flownets", init_params("flownets"))
