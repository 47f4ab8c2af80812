"""The port's profiler spans on its inference path: ``FlowRunner.batch``'s
four request phases (``fn2.runner.*``) and the cascade's sub-nets
(``fn2.net.*``), as ``torch.profiler`` records them on the CPU. The
benchmark's ``program_span`` metrics read these names."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flownet2_tpu_torch.checkpoint import init_params
from flownet2_tpu_torch.inference import FlowRunner

PHASES = ["fn2.runner.prepare", "fn2.runner.upload", "fn2.runner.forward", "fn2.runner.download"]
SUBNETS = {
    "flownet2": ["flownetc", "flownets_1", "flownets_2", "flownetsd", "fusion"],
    "flownet2-css": ["flownetc", "flownets_1", "flownets_2"],
    "flownet2-cs": ["flownetc", "flownets_1"],
}


@pytest.fixture(scope="module")
def cascade_weights():
    """One seeded set serves the three models: they share FlowNet2's sub-nets."""
    return init_params("flownet2", seed=2)


def _spans(prof, prefix: str) -> list:
    """(name, start us, end us) of the ranges named ``prefix*``, by start."""
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith(prefix)]
    return sorted(spans, key=lambda s: s[1])


# uint8 frames (the cases' first ids) and the same frames as float32
FRAME_CASES = [pytest.param(model, np.uint8, id=model) for model in SUBNETS] + [
    pytest.param(model, np.float32, id=f"{model}-float32") for model in SUBNETS
]


@pytest.mark.parametrize("model, frame_dtype", FRAME_CASES)
def test_batch_opens_the_runner_phases_and_the_cascade_subnets(model, frame_dtype, cascade_weights):
    runner = FlowRunner(model, cascade_weights, device="cpu")
    rng = np.random.default_rng(3)
    i0, i1 = (rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8).astype(frame_dtype) for _ in range(2))
    plain = runner.batch(i0, i1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = runner.batch(i0, i1)
    assert np.array_equal(traced, plain)

    phases = _spans(prof, "fn2.runner.")
    assert [name for name, _, _ in phases] == PHASES
    for (_, _, end), (_, start, _) in zip(phases, phases[1:]):
        assert end <= start  # one after another, none nested in another

    _, fwd_start, fwd_end = phases[2]
    nets = _spans(prof, "fn2.net.")
    assert [name for name, _, _ in nets] == [f"fn2.net.{n}" for n in SUBNETS[model]]
    assert all(fwd_start <= start and end <= fwd_end for _, start, end in nets)
    for (_, _, end), (_, start, _) in zip(nets, nets[1:]):
        assert end <= start
