"""A run, past the look for a card, at a small size on the CPU: sound, it
comes out correct; with the timed path broken underneath
(``harness/faults.py``), once for each fault the cell can have, it comes
out not correct. The training cells' files are kept for a later PR
(``BENCHMARK.json`` does not list them) and are held to the same. Also the
result line's keys."""

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness.cell import load_cell, unlisted_cell
from benchmark.harness.common import Result
from benchmark.harness.faults import planted
from benchmark.harness.trace import Interval, Stretch

CPU = torch.device("cpu")
SMALL = {
    "flownet2.sintel-b4": dict(height=100, width=130, pool_requests=2, check_requests=2, warmup_requests=1,
                               pairs_per_request=2),
    "flownet2.chairs-b16": dict(height=64, width=128, pool_requests=2, check_requests=2, warmup_requests=1,
                                pairs_per_request=2),
    "flownetc.chairs-aug-b8": dict(samples=6, source_height=96, source_width=160, crop_height=64, crop_width=128,
                                   batch=2, warmup_steps=4, chunk_steps=2),
    "flownetc.chairs-crop-b8": dict(samples=6, source_height=96, source_width=160, crop_height=64, crop_width=128,
                                    batch=2, warmup_steps=4, chunk_steps=2),
}
FAULTS = {
    "flownet2.sintel-b4": [None, "altered_answer", "half_batch"],
    "flownet2.chairs-b16": [None, "altered_answer", "half_batch"],
    "flownetc.chairs-aug-b8": [None, "state_unchanged", "half_batch", "altered_answer"],
    "flownetc.chairs-crop-b8": [None, "state_unchanged", "half_batch", "altered_answer"],
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


def _run(name, fault):
    cell = load_cell(name) if name.startswith("flownet2.") else unlisted_cell(name)
    cell.traffic.update(SMALL[name])
    from benchmark.harness.cell import driver

    with planted(fault):
        return cell, driver(cell).run(cell, 2**31 + 11, 0.5, False, CPU)


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_makes_the_run_not_correct(name, fault):
    cell, result = _run(name, fault)
    assert result.attempted > 0 and set(result.checks) == set(cell.limits)
    assert bench_run.is_correct(result) == (fault is None), {k: (c.value, c.limit) for k, c in result.checks.items()}


def _line(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "test card")
    monkeypatch.setattr(bench_run, "power_limit", lambda: "700.00 W")
    cell = load_cell("flownet2.sintel-b4")
    stretch = Stretch(0.5, [Interval("flow_warp_kernel", 0.0, 10.0), Interval("Memcpy HtoD", 20.0, 30.0)], [],
                      [Interval("bench.request", 0.0, 100.0)], {}, {"requests": 1, "pairs": 1},
                      dict(cell.traffic, model="flownet2"))
    result = Result(12.5, 10, 0, {"pairs_per_s": 50.0, "latency_p95_ms": 20.0}, 123, {}, stretch if trace else None)
    return bench_run.result_line(cell, result, trace, CPU)


def test_the_result_lines_keys(monkeypatch):
    plain = _line(monkeypatch, 0)
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(plain["metrics"]) == {"pairs_per_s", "latency_p95_ms", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(plain["device"])
    traced = _line(monkeypatch, 1)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert traced["device"]["busy_s"] == 20e-6 and traced["device"]["window_s"] == 0.5
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "device_idle.infer" in traced["metrics"] and "pairs_per_s" not in traced["metrics"]
    json.dumps(traced)
