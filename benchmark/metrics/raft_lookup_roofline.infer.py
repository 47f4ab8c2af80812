"""The lookup against its bound: the least time of a request's lookups
(``raft_readers.lookup_bound_s``: 324 float32 outputs written and two
coordinates read a 1/8-resolution pixel, an update) over the device time
inside the ``fn2.raft.lookup`` spans. The same work whatever implements it."""

from benchmark.harness.raft_readers import LOOKUP, lookup_bound_s, padded, roofline


def read(st):
    h, w = padded(st)
    bound = lookup_bound_s(st.cell["pairs_per_request"], h // 8, w // 8) * st.cell.get("iters", 0)
    return roofline(st, LOOKUP, bound)
