"""Port ResNet50 (frozen BN) vs the JAX package at stage_sizes (1,1,1,1)
on a 32x32 input, with randomized BN statistics. fp32; the outputs grow
through the unnormalized residual stack, so the bar is 1e-5 of the
output's largest magnitude (convolution sums in another order)."""

import numpy as np
import torch

import jax

from layoutdetr_tpu.models.resnet import ResNet50 as JaxResNet50
from layoutdetr_tpu_torch.models.resnet import ResNet50
from layoutdetr_tpu_torch.utils.convert import JaxParams

from test_torch_common import load_port, max_abs, randomize_tree, to_numpy_tree
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def test_resnet50_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxResNet50(stage_sizes=(1, 1, 1, 1))
    params = randomize_tree(to_numpy_tree(jm.init(jax.random.PRNGKey(0), x)["params"]), scale=0.05)
    want = np.asarray(jm.apply({"params": params}, x))  # [2, 1, 1, 2048]

    c = JaxParams(params)
    c.resnet("", "", (1, 1, 1, 1))
    port = load_port(ResNet50((1, 1, 1, 1)), c.finish())
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    assert max_abs(got, want) <= 1e-5 * scale, (max_abs(got, want), scale)
