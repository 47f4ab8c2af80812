"""Host ms a request in ``fn2.runner.prepare``: ``FlowRunner.batch``'s
numpy conversion of both frames to float32."""

from benchmark.harness.spans import host_ms_per


def read(st):
    return host_ms_per(st, "fn2.runner.prepare")
