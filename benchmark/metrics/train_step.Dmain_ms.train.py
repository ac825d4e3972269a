"""Device time of the kernels the port's train_step.Dmain range launches (the
union of their intervals), ms a step."""

from benchmark.harness import readers


def read(probe):
    return readers.range_ms(probe, ["train_step.Dmain"])
