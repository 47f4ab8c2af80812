"""The nine readers of the program's spans (``harness/spans.py``) on a
hand-built stretch of two requests of two pairs each, whose host ranges,
device-side spans and device intervals are laid out below (us, the
profiler's clock; request 2 is request 1 shifted by 100 us):

    host      prepare 0-10, upload 10-20, forward 20-70, download 70-100
    device    HtoD 15-20; kernels C 25-40, S1 45-50, S2 50-55, SD 55-58,
              fusion 58-60; DtoH 80-85
    spans     fn2.net.<sub-net> on the device from its kernel's start to its end

Idle, request 1: before 15 nothing has run (not a gap); forward holds the
gaps 20-25, 40-45 and 60-70 (20 us), download 70-80 and 85-100 (25 us).
Request 2: the 85-115 gap puts 15 us in request 1's download, 10 in
prepare and 5 in upload; forward again 20 us; download 170-180 (10 us),
and after 185 nothing runs (not a gap). So I/O idle 50 us over 2
requests, launch idle 40.
"""

import pytest

from benchmark.harness.cell import metric_reader
from benchmark.harness.trace import Interval, Stretch

PHASES = {"fn2.runner.prepare": (0, 10), "fn2.runner.upload": (10, 20), "fn2.runner.forward": (20, 70),
          "fn2.runner.download": (70, 100)}
KERNELS = {"fn2.net.flownetc": (25, 40), "fn2.net.flownets_1": (45, 50), "fn2.net.flownets_2": (50, 55),
           "fn2.net.flownetsd": (55, 58), "fn2.net.fusion": (58, 60)}

# metric -> (hand-worked value, ms; the spans it reads; where they lie)
EXPECTED = {
    "prepare_ms.infer": (0.010, ["fn2.runner.prepare"], "cpu"),
    "upload_ms.infer": (0.010, ["fn2.runner.upload"], "cpu"),
    "forward_host_ms.infer": (0.050, ["fn2.runner.forward"], "cpu"),
    "io_idle_ms.infer": (0.025, ["fn2.runner.prepare", "fn2.runner.upload", "fn2.runner.download"], "cpu"),
    "launch_idle_ms.infer": (0.020, ["fn2.runner.forward"], "cpu"),
    "flownetc_ms.infer": (0.0075, ["fn2.net.flownetc"], "annotations"),
    "flownets_ms.infer": (0.005, ["fn2.net.flownets_1", "fn2.net.flownets_2"], "annotations"),
    "flownetsd_ms.infer": (0.0015, ["fn2.net.flownetsd"], "annotations"),
    "fusion_ms.infer": (0.001, ["fn2.net.fusion"], "annotations"),
}


def stretch() -> Stretch:
    cpu, device, annotations = [], [], []
    for t in (0, 100):
        cpu.append(Interval("bench.request", t, t + 100))
        cpu += [Interval(name, t + s, t + e) for name, (s, e) in PHASES.items()]
        cpu.append(Interval("aten::copy_", t + 12, t + 19))
        device.append(Interval("Memcpy HtoD (Pageable -> Device)", t + 15, t + 20))
        device += [Interval(f"kernel_{name}", t + s, t + e) for name, (s, e) in KERNELS.items()]
        device.append(Interval("Memcpy DtoH (Device -> Pageable)", t + 80, t + 85))
        annotations += [Interval(name, t + s, t + e) for name, (s, e) in KERNELS.items()]
        annotations.append(Interval("bench.request", t + 15, t + 85))
    return Stretch(200e-6, device, annotations, cpu, {}, {"requests": 2, "pairs": 4},
                   {"model": "flownet2", "pairs_per_request": 2})


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_each_reader_gives_its_hand_worked_value(metric):
    assert metric_reader(metric)(stretch()) == pytest.approx(EXPECTED[metric][0], rel=1e-12)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_a_reader_whose_span_is_missing_reads_nothing(metric):
    _, names, where = EXPECTED[metric]
    for name in names:
        st = stretch()
        setattr(st, where, [e for e in getattr(st, where) if e.name != name])
        assert metric_reader(metric)(st) is None, name


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_a_reader_whose_span_is_not_one_a_request_reads_nothing(metric):
    _, names, where = EXPECTED[metric]
    for name in names:
        once = stretch()  # request 2 lost the span
        setattr(once, where, [e for e in getattr(once, where) if not (e.name == name and e.start >= 100)])
        twice = stretch()  # request 1 opened it again
        extra = next(e for e in getattr(twice, where) if e.name == name)
        getattr(twice, where).append(Interval(name, extra.start, extra.end))
        assert metric_reader(metric)(once) is None and metric_reader(metric)(twice) is None, name
