"""CUDA kernels the port's train_step.G_adam, train_step.D_adam and
train_step.ema spans launch (the gradients' sanitizing, Adam and the EMA),
a step."""

from benchmark.harness import spans


def read(probe):
    return spans.launches(probe, ["train_step.G_adam", "train_step.D_adam", "train_step.ema"])
