"""Host ms a request in ``fn2.runner.forward`` (``FlowRunner.run``): the
enqueue of the adapt, the nets and the restore, plus any wait for the
device inside ``run``."""

from benchmark.harness.spans import host_ms_per


def read(st):
    return host_ms_per(st, "fn2.runner.forward")
