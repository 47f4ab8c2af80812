"""Device ms a pair of the kernels inside the device-side spans of
``fn2.net.flownets_1`` and ``fn2.net.flownets_2``: the two FlowNetS stages."""

from benchmark.harness.spans import subnets_ms_per_pair


def read(st):
    return subnets_ms_per_pair(st, ("fn2.net.flownets_1", "fn2.net.flownets_2"))
