"""The benchmark's plain reference: a frozen copy of the LayoutDETR
Generator and Discriminator, their GAN loss, Adam and EMA, in plain
PyTorch.

It follows the program's models layer for layer, with the program's
parameter names, and draws its randomness in the same order from the same
generators, so that one seed gives both the same noise and dropout masks.
Where the program runs a hand-written kernel, the reference computes the
same function with plain tensor ops: ``attention.attention`` (softmax
attention, with the kernel's Philox keep mask worked out again from its
seed) and ``bias_act.bias_act`` (differentiated by autograd). It has no
tensor or data parallelism, no ADA and no regularization steps.

Nothing here imports the program or JAX; ``tests/test_imports.py`` holds
the package to that.
"""
