"""The volume against its bound: the least time of a request's product and
pyramid (``raft_readers.volume_bound_s``: the pyramid written once, f1 and
f2 read, or the product's operations at TF32's peak) over the device time
inside ``fn2.raft.volume``."""

from benchmark.harness.raft_readers import padded, roofline, volume_bound_s


def read(st):
    h, w = padded(st)
    return roofline(st, "fn2.raft.volume", volume_bound_s(st.cell["pairs_per_request"], h // 8, w // 8))
