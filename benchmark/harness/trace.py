"""The traced stretch: ``torch.profiler`` (CPU and CUDA) over a steady run of
the window, reduced to what the per-layer metrics read.

The device's busy time is the union of its kernel, copy and memset
intervals (user annotations left out: the device-side span of a
``record_function`` range covers the gaps between its kernels), as the
port's ``chip_smoke.py::busy_ms`` and ``scripts/profile_slice.py::busy_us``
compute it. The wall time of the stretch is the host's clock from a
drained queue to a drained queue.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

TOP = 10  # entries of each breakdown list
LABELLED_GAPS = 2000  # the longest idle gaps, each labelled by what the host was doing
BACK_SCAN = 400  # host ops before a gap searched for the one it fell in


@dataclass
class Interval:
    name: str
    start: float  # us, the profiler's clock
    end: float

    @property
    def us(self) -> float:
        return self.end - self.start


@dataclass
class Stretch:
    """What the metric readers read: the traced stretch's device intervals,
    CPU ranges, aten ops' self device times, its wall seconds, the units of
    work in it (requests, pairs, steps) and the cell's own numbers."""

    wall_s: float
    device: list  # Interval: kernels, copies, memsets
    annotations: list  # Interval: device-side spans of record_function ranges
    cpu: list  # Interval: host ops and ranges
    op_device_us: dict  # aten op -> self device us
    units: dict = field(default_factory=dict)
    cell: dict = field(default_factory=dict)

    def busy_us(self) -> float:
        return union_us(self.device)

    def kernels(self, pattern: str) -> list:
        return [e for e in self.device if pattern in e.name]

    def copies_us(self) -> float:
        return sum(e.us for e in self.device if e.name.startswith("Memcpy"))


def union_us(intervals) -> float:
    total, start, end = 0.0, None, None
    for s, e in sorted((i.start, i.end) for i in intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


class Tracer:
    """Profiles the calls made between :meth:`start` and :meth:`stop`;
    both wait for the device."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.wall = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def stretch(self, units: dict, cell: dict) -> Stretch:
        device, annotations, cpu = [], [], []
        for e in self.prof.events():
            iv = Interval(e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                (annotations if e.is_user_annotation else device).append(iv)
            else:
                cpu.append(iv)
        ops = {r.key: r.self_device_time_total for r in self.prof.key_averages()}
        return Stretch(self.wall, device, annotations, cpu, ops, units, cell)


def breakdown(st: Stretch) -> dict:
    """The device operations that took most time (kernel and copy names, in
    seconds) and the longest idle gaps, summed by what the host was doing
    when the device went idle: the benchmark's own span and the innermost
    host op at the gap's start."""
    by_name: dict = {}
    for e in st.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    ivs = sorted((e.start, e.end) for e in st.device)
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    rest = sum(g1 - g0 for g0, g1 in gaps[LABELLED_GAPS:]) / 1e6
    spans = [c for c in st.cpu if c.name.startswith("bench.")]
    ops_cpu = sorted((c for c in st.cpu if not c.name.startswith("bench.")), key=lambda c: c.start)
    starts = [c.start for c in ops_cpu]
    by_host: dict = {}
    for g0, g1 in gaps[:LABELLED_GAPS]:
        span = next((c.name for c in spans if c.start <= g0 < c.end), "outside a benchmark span")
        i = bisect.bisect_right(starts, g0)
        inner = [c for c in ops_cpu[max(0, i - BACK_SCAN):i] if g0 < c.end]
        op = min(inner, key=lambda c: c.us).name if inner else "no host op"
        key = f"{span} / {op}"
        by_host[key] = by_host.get(key, 0.0) + (g1 - g0) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP - 1]
    if rest:
        idle.append((f"the {len(gaps) - LABELLED_GAPS} shorter gaps, unlabelled", rest))
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
