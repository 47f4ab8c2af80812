"""Device ms a request of host-to-device and device-to-host copies: the
frames going up and the flow coming back in ``FlowRunner.batch``."""

from benchmark.harness.readers import copies_ms_per


def read(st):
    return copies_ms_per(st, "requests")
