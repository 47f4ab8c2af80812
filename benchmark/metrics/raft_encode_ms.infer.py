"""Device ms a pair of the kernels inside the device-side span of
``fn2.raft.encode``: RAFT's two encoders (fnet on both frames, cnet on the first)."""

from benchmark.harness.raft_readers import ms_per_pair


def read(st):
    return ms_per_pair(st, "fn2.raft.encode")
