"""Device ms a pair of the kernels inside the device-side spans of
``fn2.raft.lookup``: the 4-level 9x9 window lookups, one an update."""

from benchmark.harness.raft_readers import LOOKUP, ms_per_pair


def read(st):
    return ms_per_pair(st, LOOKUP)
