"""Device ms a pair of the kernels inside the device-side span of
``fn2.net.flownetsd``: the small-displacement net."""

from benchmark.harness.spans import subnets_ms_per_pair


def read(st):
    return subnets_ms_per_pair(st, ("fn2.net.flownetsd",))
