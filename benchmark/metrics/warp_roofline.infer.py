"""K1 (``csrc/warp.cu``) against its bound: the cascade's four warps of the
second frame a request (S1, S2, and the SD and CSS brightness errors), on
3-channel frames at the adapted size."""

from benchmark.harness import yardstick
from benchmark.harness.readers import adapted, roofline


def read(st):
    h, w = adapted(st.cell["height"], st.cell["width"])
    bound = yardstick.warp_bound(st.cell["pairs_per_request"], 3, h, w)
    return roofline(st, "flow_warp_kernel", [bound] * 4, "requests")
