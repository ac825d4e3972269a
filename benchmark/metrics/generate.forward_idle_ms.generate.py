"""The card's idle time within G's forward, where the host dispatches
slower than the card runs, ms a request: the device-only stretch's idle
times the share of the fully profiled stretch's idle within the port's
generate.forward span (``spans.idle_ms``)."""

from benchmark.harness import spans


def read(probe):
    return spans.idle_ms(probe, ["generate.forward"])
