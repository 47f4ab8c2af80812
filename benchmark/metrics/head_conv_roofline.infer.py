"""K3 (``csrc/head_conv.cu``) against its bound: the least time of a
request's head-layer launches over their measured device time. K3 runs only
where the port routes the head layers to it (full-resolution width above
512); elsewhere there is nothing to read."""

from benchmark.harness import yardstick
from benchmark.harness.readers import adapted, roofline


def read(st):
    h, w = adapted(st.cell["height"], st.cell["width"])
    n = st.cell["pairs_per_request"]
    bounds = [yardstick.head_conv_bound(x, wt, kind, s) for kind, x, wt, s in
              yardstick.head_layers(st.cell["model"], n, h, w)]
    return roofline(st, "head_conv_f32_kernel", bounds, "requests")
