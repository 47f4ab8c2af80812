"""Device ms a step of the optimizer: the kernels inside the device-side
spans of the profiler's automatic ``Optimizer.step#CaffeSolver.step`` range."""

from benchmark.harness.readers import range_device_ms_per


def read(st):
    return range_device_ms_per(st, "Optimizer.step#CaffeSolver.step", "steps")
