"""``FlowRunner.batch``'s frame upload on the CPU: uint8 frames give the flow
of the same frames passed as float32, bit for bit, through ``batch`` and
``__call__``; uint16 and float64 frames take the host's float32 conversion;
a CPU runner never stages (``FlowRunner.u8_uploads`` stays put). The card's
pinned staging path is tested in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest

from flownet2_tpu_torch.checkpoint import init_params
from flownet2_tpu_torch.inference import FlowRunner

MODELS = ["flownets", "flownet2-cs"]


@pytest.fixture(scope="module", params=MODELS)
def runner(request):
    return FlowRunner(request.param, init_params(request.param, seed=4), device="cpu")


def _frames(n=2, h=64, w=96, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8) for _ in range(2)]


def test_uint8_frames_give_the_float32_frames_flow(runner):
    u0, u1 = _frames()
    uploads = FlowRunner.u8_uploads
    want = runner.batch(u0.astype(np.float32), u1.astype(np.float32))
    np.testing.assert_array_equal(runner.batch(u0, u1), want)
    # one pair against one pair: a batch of one may take other conv algorithms than a batch of two
    np.testing.assert_array_equal(runner(u0[1], u1[1]), runner(u0[1].astype(np.float32), u1[1].astype(np.float32)))
    assert FlowRunner.u8_uploads == uploads  # a CPU runner never stages
    assert runner._staging == (None, None)


@pytest.mark.parametrize("dtype", [np.uint16, np.float64], ids=["uint16", "float64"])
def test_other_frame_dtypes_take_the_host_conversion(runner, dtype):
    u0, u1 = _frames(seed=7)
    uploads = FlowRunner.u8_uploads
    want = runner.batch(u0.astype(np.float32), u1.astype(np.float32))
    np.testing.assert_array_equal(runner.batch(u0.astype(dtype), u1.astype(dtype)), want)
    np.testing.assert_array_equal(runner(u0[0].astype(dtype), u1[0].astype(dtype)),
                                  runner(u0[0].astype(np.float32), u1[0].astype(np.float32)))
    assert FlowRunner.u8_uploads == uploads
