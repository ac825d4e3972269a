"""The card's idle time while the host copies a request's inputs to it, ms
a request: the device-only stretch's idle times the share of the fully
profiled stretch's idle within the port's generate.upload span
(``spans.idle_ms``)."""

from benchmark.harness import spans


def read(probe):
    return spans.idle_ms(probe, ["generate.upload"])
