"""CUDA kernels the port's train_step.forward span launches (the losses'
forward in Gmain and Dmain), a step."""

from benchmark.harness import spans


def read(probe):
    return spans.launches(probe, ["train_step.forward"])
