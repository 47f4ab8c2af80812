"""Device ms a pair of the kernels inside the device-side span of
``fn2.raft.volume``: the all-pairs product and its 4-level pyramid."""

from benchmark.harness.raft_readers import ms_per_pair


def read(st):
    return ms_per_pair(st, "fn2.raft.volume")
