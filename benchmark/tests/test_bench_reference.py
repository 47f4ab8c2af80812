"""The plain reference against the port's CPU path at small sizes (this
test imports both), and the yardstick's counts against numbers worked out
by hand."""

import numpy as np
import pytest
import torch

from benchmark.harness import yardstick
from benchmark.harness.cell import unlisted_cell
from benchmark.harness.weights import make_weights
from benchmark.reference import nets
from benchmark.reference.train import sample_coefficients
from benchmark.traffic import infer, train

CPU = torch.device("cpu")


def test_reference_layers_are_the_ports():
    from flownet2_tpu_torch.checkpoint import expected_params

    for model in ("flownetc", "flownet2"):
        assert nets.param_shapes(model) == expected_params(model)


@pytest.mark.parametrize("h,w,n", [(100, 130, 2), (64, 192, 1)])
def test_reference_flow_equals_the_ports_cpu_path(h, w, n):
    from flownet2_tpu_torch.inference import FlowRunner

    params = make_weights("flownet2", 11, CPU)
    rng = np.random.default_rng(3)
    img0, img1 = (rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8) for _ in range(2))
    got = FlowRunner("flownet2", params, device=CPU).batch(img0, img1)
    ref = infer.reference_flows(params, "flownet2", img0, img1, CPU).numpy()
    assert got.shape == ref.shape == (n, h, w, 2)
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_sampler_copy_draws_the_ports_coefficients():
    from flownet2_tpu_torch.data.augment_pipeline import FlowNetAugConfig, sample_aug_arrays

    for seed, k in ((0, 0), (2**31 + 7, 1), (12345, 5)):
        mine = sample_coefficients(np.random.default_rng([seed, k]), 8, 384, 512, 320, 448)
        port = sample_aug_arrays(FlowNetAugConfig(), np.random.default_rng([seed, k]), 8, 384, 512, 320, 448)
        for key, value in mine.items():
            np.testing.assert_array_equal(value, port[f"aug_{key}"])


@pytest.mark.parametrize("cell_name", ["flownetc.chairs-aug-b8", "flownetc.chairs-crop-b8"])
def test_reference_steps_follow_the_ports_first_steps(cell_name):
    cell = unlisted_cell(cell_name)
    cell.traffic.update(samples=6, source_height=96, source_width=160, crop_height=64, crop_width=128, batch=2)
    got = train.readings(cell, 2**31 + 3, CPU, False)["program"][0]
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3, got


def test_conv_and_deconv_operations_a_pair():
    f = yardstick.forward_flops
    assert round((f("flownet2", 320, 448)["conv"] + f("flownet2", 320, 448)["deconv"]) / 1e9, 1) == 144.6
    assert round((f("flownet2", 448, 1024)["conv"] + f("flownet2", 448, 1024)["deconv"]) / 1e9, 1) == 462.6
    assert round((f("flownetc", 320, 448)["conv"] + f("flownetc", 320, 448)["deconv"]) / 1e9, 1) == 32.6
    # the cost volume: 2 operations per channel, displacement and pixel of the conv3 map
    assert f("flownetc", 320, 448)["corr"] == 2 * 256 * 441 * 40 * 56
    assert f("flownet2", 448, 1024)["corr"] == 2 * 256 * 441 * 56 * 128


def test_training_operations_a_pair():
    fwd = sum(yardstick.forward_flops("flownetc", 320, 448).values())
    conv1 = 2 * 2 * (160 * 224 * 64) * 3 * 49  # both towers' first layer: its input gradient is not needed
    assert yardstick.train_flops("flownetc", 320, 448) == 3 * fwd - conv1


def test_bounds_by_hand():
    # K5 forward at Sintel's conv3 features: 2 maps read, 441 channels written, in float32
    n, c, h, w = 1, 256, 56, 128
    assert yardstick.corr_bound(n, c, h, w) == max(4 * (2 * c * h * w + 441 * h * w) / 3.35e12,
                                                   2 * 441 * h * w * c / 495e12)
    assert yardstick.corr_bwd_bound(8, 256, 40, 56) == max(4 * (4 * 8 * 256 * 40 * 56 + 8 * 441 * 40 * 56) / 3.35e12,
                                                           4 * 8 * 441 * 40 * 56 * 256 / 495e12)
    assert yardstick.warp_bound(8, 3, 384, 512) == 4 * 8 * 384 * 512 * 8 / 3.35e12
    # K3: 12 head layers at width 1024, none at 448; conv0 of the fusion net by hand
    layers = yardstick.head_layers("flownet2", 1, 448, 1024)
    assert len(layers) == 12 and yardstick.head_layers("flownet2", 16, 320, 448) == []
    fusion0 = yardstick.head_conv_bound((1, 11, 448, 1024), (64, 11, 3, 3), "conv", 1)
    assert fusion0 == max(4 * (11 * 448 * 1024 + 64 * 11 * 9 + 64 + 64 * 448 * 1024) / 3.35e12,
                          2 * 64 * 448 * 1024 * 11 * 9 / 495e12)
