"""Device ms a pair of the kernels inside the device-side span of
``fn2.net.flownetc``: FlowNetC, the cascade's first sub-net."""

from benchmark.harness.spans import subnets_ms_per_pair


def read(st):
    return subnets_ms_per_pair(st, ("fn2.net.flownetc",))
