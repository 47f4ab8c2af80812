"""Device-idle ms a request while the host is in ``fn2.runner.forward``:
the card waiting for ``FlowRunner.run`` to enqueue its work."""

from benchmark.harness.spans import idle_ms_per


def read(st):
    return idle_ms_per(st, ("fn2.runner.forward",))
