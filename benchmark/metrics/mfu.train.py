"""The whole training step's share of the card's TF32 peak: a pair's forward
conv, deconv and correlation operations and twice them for the backward,
less the first layers' input gradient (``harness/yardstick.train_flops``),
times the pairs the stretch trained per second."""

from benchmark.harness import yardstick
from benchmark.harness.readers import share_of_peak


def read(st):
    return share_of_peak(yardstick.train_flops(st.cell["model"], st.cell["crop_height"], st.cell["crop_width"]), st)
