"""RAFT's whole forward as a share of the card's TF32 peak: a pair's product
operations at the padded size (``reference/raft.py::forward_flops``: the
three encoder passes, the volume, every update, the mask head once) times
the pairs the stretch completed per second. None outside RAFT's spans."""

from benchmark.harness.raft_readers import flops_per_pair, padded, spans
from benchmark.harness.readers import share_of_peak


def read(st):
    if spans(st, "fn2.raft.refine") is None:
        return None
    h, w = padded(st)
    return share_of_peak(flops_per_pair(h, w, st.cell["iters"]), st)
