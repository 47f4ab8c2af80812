"""The arithmetic the per-layer metrics share. Each metric's own file under
``benchmark/metrics/`` names its quantity and calls one of these on the
traced stretch (``trace.Stretch``); a reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

import math

from benchmark.harness import yardstick
from benchmark.harness.trace import union_us


def adapted(h: int, w: int) -> tuple[int, int]:
    """The /64-adapted size ``FlowRunner`` runs the nets at."""
    return int(math.ceil(h / 64) * 64), int(math.ceil(w / 64) * 64)


def idle_pct(st) -> float | None:
    if st.wall_s <= 0 or not st.device:
        return None
    return 100.0 * (1.0 - st.busy_us() / 1e6 / st.wall_s)


def share_of_peak(flops_per_pair: float, st) -> float | None:
    """100 x operations done per second in the stretch over the product peak."""
    pairs = st.units.get("pairs", 0)
    if not pairs or st.wall_s <= 0:
        return None
    return 100.0 * flops_per_pair * pairs / st.wall_s / yardstick.PEAK_TF32_FLOPS


def op_ms_per(st, ops: tuple, unit: str) -> float | None:
    """Self device ms of the aten ``ops`` per ``unit`` of the stretch."""
    us = sum(st.op_device_us.get(op, 0.0) for op in ops)
    n = st.units.get(unit, 0)
    return us / 1e3 / n if us and n else None


def copies_ms_per(st, unit: str) -> float | None:
    us, n = st.copies_us(), st.units.get(unit, 0)
    return us / 1e3 / n if us and n else None


def roofline(st, pattern: str, bounds_s: list, unit: str) -> float | None:
    """100 x the least time of the launches over their measured device time.
    ``bounds_s``: the bound of each launch of one ``unit`` (a request, a
    step); the stretch must hold exactly that many launches per unit."""
    launches = st.kernels(pattern)
    n = st.units.get(unit, 0)
    if not bounds_s or not n or len(launches) != len(bounds_s) * n:
        return None
    return 100.0 * n * sum(bounds_s) / (sum(e.us for e in launches) / 1e6)


def range_device_ms_per(st, name: str, unit: str) -> float | None:
    """Device ms a ``unit`` of the kernels that ran inside the device-side
    spans of the ``record_function`` range ``name`` (the union of their
    intervals, clipped to the span: the gaps between them left out)."""
    spans = [a for a in st.annotations if a.name == name]
    n = st.units.get(unit, 0)
    if not spans or not n:
        return None
    kernels = [e for e in st.device if not e.name.startswith("Memcpy") and not e.name.startswith("Memset")]
    us = 0.0
    for s in spans:
        inside = [type(e)(e.name, max(e.start, s.start), min(e.end, s.end)) for e in kernels
                  if e.end > s.start and e.start < s.end]
        us += union_us(inside)
    return us / 1e3 / n
