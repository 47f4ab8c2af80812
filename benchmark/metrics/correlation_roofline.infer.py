"""K5's forward (``csrc/correlation.cu``) against its bound: one launch a
request, on FlowNetC's conv3 features (256 channels at 1/8 of the adapted size)."""

from benchmark.harness import yardstick
from benchmark.harness.readers import adapted, roofline


def read(st):
    h, w = adapted(st.cell["height"], st.cell["width"])
    bound = yardstick.corr_bound(st.cell["pairs_per_request"], 256, h // 8, w // 8)
    return roofline(st, "correlation_kernel", [bound], "requests")
