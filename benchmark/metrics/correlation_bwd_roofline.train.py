"""K5's backward (``csrc/correlation_bwd.cu``) against its bound: one launch
a step, on FlowNetC's conv3 features (256 channels at 1/8 of the crop)."""

from benchmark.harness import yardstick
from benchmark.harness.readers import roofline


def read(st):
    c = st.cell
    bound = yardstick.corr_bwd_bound(c["batch"], 256, c["crop_height"] // 8, c["crop_width"] // 8)
    return roofline(st, "correlation_backward_kernel", [bound], "steps")
