"""The card's idle time in the losses' forward in Gmain and Dmain, ms a
step: the device-only stretch's idle times the share of the fully profiled
stretch's idle within the port's train_step.forward span
(``spans.idle_ms``)."""

from benchmark.harness import spans


def read(probe):
    return spans.idle_ms(probe, ["train_step.forward"])
