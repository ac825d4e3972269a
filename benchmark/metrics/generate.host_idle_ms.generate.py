"""The card's idle time while the host encodes a request (tokens, noise,
padding) or post-processes its layouts, ms a request: the device-only
stretch's idle times the share of the fully profiled stretch's idle within
the port's generate.encode and generate.postprocess spans
(``spans.idle_ms``)."""

from benchmark.harness import spans


def read(probe):
    return spans.idle_ms(probe, ["generate.encode", "generate.postprocess"])
