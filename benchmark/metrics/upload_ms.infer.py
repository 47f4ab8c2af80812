"""Host ms a request in ``fn2.runner.upload``: ``FlowRunner.batch``'s
``torch.as_tensor(..., device=...)`` of both float32 frames (a blocking
copy from pageable memory)."""

from benchmark.harness.spans import host_ms_per


def read(st):
    return host_ms_per(st, "fn2.runner.upload")
