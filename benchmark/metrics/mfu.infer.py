"""The whole forward's share of the card's TF32 peak: a pair's conv, deconv
and correlation operations at the adapted size, counted by the benchmark
(``harness/yardstick.forward_flops``), times the pairs the stretch completed
per second."""

from benchmark.harness import yardstick
from benchmark.harness.readers import adapted, share_of_peak


def read(st):
    h, w = adapted(st.cell["height"], st.cell["width"])
    return share_of_peak(sum(yardstick.forward_flops(st.cell["model"], h, w).values()), st)
