"""Device ms a pair inside ``fn2.raft.refine`` less that inside its
``fn2.raft.lookup`` spans: the update block of every update (motion
encoder, GRU, flow head) and the mask head with the upsampling."""

from benchmark.harness.raft_readers import LOOKUP, ms_per_pair


def read(st):
    refine, lookup = ms_per_pair(st, "fn2.raft.refine"), ms_per_pair(st, LOOKUP)
    return None if refine is None or lookup is None else refine - lookup
