"""The arithmetic of RAFT's per-layer metrics: device time inside the
device-side spans of the port's ``fn2.raft.*`` ranges (``models/raft.py``),
the bounds of the volume and the lookup, and the whole forward's
operations (``reference/raft.py::forward_flops``). A reader whose spans are
missing, or not as many a request as RAFT opens them (``encode``,
``volume`` and ``refine`` once, ``lookup`` once an update), returns None.
"""

from __future__ import annotations

import bisect
from functools import lru_cache

from benchmark.harness import spans as span_readers
from benchmark.harness import yardstick
from benchmark.harness.trace import Interval, union_us
from benchmark.reference import raft as ref

LOOKUP = "fn2.raft.lookup"
F32 = 4


def spans(st, name: str) -> list | None:
    """The device-side spans of ``name``; None unless there are as many a
    request as the forward opens (``iters`` for the lookup, else one)."""
    n = st.units.get("requests", 0)
    per = st.cell.get("iters", 0) if name == LOOKUP else 1
    found = [a for a in st.annotations if a.name == name]
    return found if n and per and len(found) == per * n else None


def lookup_device_us(st) -> float | None:
    """Device us of the kernels inside the lookups' device-side spans (each
    kernel clipped to its span, the gaps between kernels left out), as
    ``readers.range_device_ms_per`` counts them; a bisect finds each span's
    kernels among the stretch's, since a request opens ``iters`` lookups."""
    found = spans(st, LOOKUP)
    if found is None:
        return None
    kernels = sorted((e for e in st.device if not e.name.startswith(("Memcpy", "Memset"))), key=lambda e: e.start)
    starts = [e.start for e in kernels]
    longest = max((e.us for e in kernels), default=0.0)
    us = 0.0
    for s in found:
        lo, hi = bisect.bisect_left(starts, s.start - longest), bisect.bisect_left(starts, s.end)
        us += union_us([Interval(e.name, max(e.start, s.start), min(e.end, s.end))
                        for e in kernels[lo:hi] if e.end > s.start])
    return us


def ms_per_pair(st, name: str) -> float | None:
    """Device ms a pair inside the spans of ``name``: the lookups here, the
    once-a-request spans through ``spans.subnets_ms_per_pair``."""
    if name != LOOKUP:
        return span_readers.subnets_ms_per_pair(st, (name,))
    us, pairs = lookup_device_us(st), st.units.get("pairs", 0)
    return None if us is None or not pairs else us / 1e3 / pairs


def padded(st) -> tuple[int, int]:
    """The /8-padded frame the net runs at."""
    top, bottom, left, right = ref.pad_to_8(st.cell["height"], st.cell["width"])
    return st.cell["height"] + top + bottom, st.cell["width"] + left + right


def volume_bound_s(n: int, h8: int, w8: int, c: int = ref.FEATURES) -> float:
    """The product and its pyramid for ``n`` pairs of (c, h8, w8) features:
    f1 and f2 read and every level written once, in float32, over the
    memory's rate; or 2 n (h8 w8)^2 c operations over TF32's peak."""
    levels, hl, wl = 0, h8, w8
    for _ in range(ref.LEVELS):
        levels += hl * wl
        hl, wl = hl // 2, wl // 2
    nbytes = F32 * (2 * n * c * h8 * w8 + n * h8 * w8 * levels)
    return yardstick.bound(nbytes, 2 * n * (h8 * w8) ** 2 * c)


def lookup_bound_s(n: int, h8: int, w8: int) -> float:
    """One lookup for ``n`` pairs: at each 1/8-resolution pixel the 324
    float32 outputs written and the two coordinates read, over the memory's
    rate. Taps outside a level need no read, so only the writes are certain."""
    k2 = ref.LEVELS * (2 * ref.RADIUS + 1) ** 2
    return yardstick.bound(F32 * n * h8 * w8 * (k2 + 2), 0.0)


def roofline(st, name: str, bound_per_request_s: float) -> float | None:
    ms, n = ms_per_pair(st, name), st.units.get("requests", 0)
    return None if not ms or not n else 100.0 * n * bound_per_request_s / (ms * st.units["pairs"] / 1e3)


@lru_cache(maxsize=8)
def flops_per_pair(h: int, w: int, iters: int) -> float:
    return float(sum(ref.forward_flops(h, w, iters).values()))
