"""Device time of the kernels the port's train_step.G_adam, train_step.D_adam
and train_step.ema ranges launch, ms a step."""

from benchmark.harness import readers


def read(probe):
    return readers.range_ms(probe, ["train_step.G_adam", "train_step.D_adam", "train_step.ema"])
