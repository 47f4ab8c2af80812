"""The arithmetic of the per-layer metrics that read the program's own
``record_function`` spans: the host ranges of ``FlowRunner``'s request
phases (``fn2.runner.*``, ``inference.py``) and the device-side spans of
the cascade's sub-nets (``fn2.net.*``, ``models/flownet2.py``). A reader
whose spans are missing, or not one a request, returns None, and the metric
is left out of the line, as on a program that opens no such spans."""

from __future__ import annotations

from benchmark.harness.readers import range_device_ms_per
from benchmark.harness.trace import Interval, union_us


def host_spans(st, names: tuple, unit: str = "requests") -> list | None:
    """The host ranges named ``names``; None unless each name occurs once a ``unit``."""
    n = st.units.get(unit, 0)
    spans = [c for c in st.cpu if c.name in names]
    if not n or any(sum(c.name == name for c in spans) != n for name in names):
        return None
    return spans


def host_ms_per(st, name: str, unit: str = "requests") -> float | None:
    """Host ms a ``unit`` inside the range ``name``."""
    spans = host_spans(st, (name,), unit)
    return None if spans is None else sum(c.us for c in spans) / 1e3 / st.units[unit]


def idle_ms_per(st, names: tuple, unit: str = "requests") -> float | None:
    """Device-idle ms a ``unit`` that falls inside the host ranges ``names``.
    Idle as ``trace.breakdown`` has it: the gaps between consecutive device
    activities (kernels, copies, memsets), so the part of a range before the
    stretch's first activity or after its last is not idle."""
    spans = host_spans(st, names, unit)
    if spans is None or not st.device:
        return None
    first, last = min(e.start for e in st.device), max(e.end for e in st.device)
    us = 0.0
    for c in spans:
        s, e = max(c.start, first), min(c.end, last)
        if e > s:
            busy = [Interval(d.name, max(d.start, s), min(d.end, e)) for d in st.device if d.end > s and d.start < e]
            us += (e - s) - union_us(busy)
    return us / 1e3 / st.units[unit]


def subnets_ms_per_pair(st, names: tuple) -> float | None:
    """Device ms a pair of the kernels inside the device-side spans of the
    sub-net ranges ``names``, summed; None unless each name has one device
    span a request."""
    n = st.units.get("requests", 0)
    if not n or any(sum(a.name == name for a in st.annotations) != n for name in names):
        return None
    parts = [range_device_ms_per(st, name, "pairs") for name in names]
    return None if None in parts else sum(parts)
