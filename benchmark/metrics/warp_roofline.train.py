"""K1 (``csrc/warp.cu``) as the augmentation's affine sample against its
bound: two launches a step, one a frame, over the canvas max(source, crop)
of 3-channel float32 frames. The unaugmented cell launches none."""

from benchmark.harness import yardstick
from benchmark.harness.readers import roofline


def read(st):
    c = st.cell
    if not c.get("augment"):
        return None
    h, w = max(c["source_height"], c["crop_height"]), max(c["source_width"], c["crop_width"])
    return roofline(st, "flow_warp_kernel", [yardstick.warp_bound(c["batch"], 3, h, w)] * 2, "steps")
