"""Device-idle ms a request while the host is in ``FlowRunner.batch``'s
I/O phases: the parts of the gaps between device activities that fall
inside ``fn2.runner.prepare``, ``upload`` or ``download``."""

from benchmark.harness.spans import idle_ms_per


def read(st):
    return idle_ms_per(st, ("fn2.runner.prepare", "fn2.runner.upload", "fn2.runner.download"))
