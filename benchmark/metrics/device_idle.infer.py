"""Share of the traced stretch in which the device ran no kernel, copy or memset (inference cells)."""

from benchmark.harness.readers import idle_pct


def read(st):
    return idle_pct(st)
