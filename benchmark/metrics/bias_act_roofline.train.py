"""The bias_act kernels' share of their roofline in the train step (the
bg_decoder of D's Dmain, forward and backward), %."""

from benchmark.harness import readers
from benchmark.rooflines import bias_act


def read(probe):
    calls = [(*bias_act.forward(c), c["itemsize"]) for c in probe["census"].bias_act]
    calls += [(*bias_act.backward(c), c["itemsize"]) for c in probe["census"].bias_act
              if c["backward"]]
    return readers.roofline(probe, "bias_act", bias_act.KERNELS, calls)
