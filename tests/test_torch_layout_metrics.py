"""Port layout losses vs the JAX package's (metrics/layout_metrics.py), with
padded elements, values and gradients. fp32, 1e-5 max-abs (values of
size ~1; the same arithmetic in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.metrics import layout_metrics as jm
from layoutdetr_tpu_torch.metrics import layout_metrics as pm

from test_torch_common import assert_max_abs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def _boxes(seed=0, b=3, n=9):
    rng = np.random.default_rng(seed)
    bbox = rng.uniform(0.05, 0.95, (b, n, 4)).astype(np.float32)
    bbox[..., 2:] *= 0.5
    bbox[0, 1] = bbox[0, 0]  # an exact duplicate: alignment's exact-1 quirk and full overlap
    mask = np.ones((b, n), bool)
    mask[1, 4:] = False
    mask[2, 7:] = False
    return bbox, mask


CASES = {
    "overlap": lambda m, x, y, k: m.compute_overlap(x, k),
    "alignment": lambda m, x, y, k: m.compute_alignment(x, k),
    "giou_masked": lambda m, x, y, k: m.generalized_iou_loss(x, y, k),
    "giou_unmasked": lambda m, x, y, k: m.generalized_iou_loss(x, y),
    "mse": lambda m, x, y, k: m.masked_mse(x, y, k),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_values_and_grads_match_jax(name):
    fn = CASES[name]
    bbox, mask = _boxes()
    tgt, _ = _boxes(seed=1)
    want = np.asarray(fn(jm, jnp.asarray(bbox), jnp.asarray(tgt), jnp.asarray(mask)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(fn(jm, x, jnp.asarray(tgt), jnp.asarray(mask))))(
        jnp.asarray(bbox)))
    x = torch.from_numpy(bbox).requires_grad_(True)
    got = fn(pm, x, torch.from_numpy(tgt), torch.from_numpy(mask))
    assert got.shape == want.shape
    assert_max_abs(got, want, 1e-5, name)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    assert_max_abs(torch.nan_to_num(got_g), np.nan_to_num(want_g), 1e-5, f"{name} grad")


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 9, 8)).astype(np.float32) * 2
    labels = rng.integers(0, 8, (3, 9))
    _, mask = _boxes()
    want = np.asarray(jm.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                              jnp.asarray(mask)))
    got = pm.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    assert_max_abs(got, want, 1e-5, "masked_cross_entropy")
    none = pm.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.zeros(3, 9, dtype=torch.bool))
    assert float(none) == 0.0  # no valid row: 0 / max(0, 1)


def test_convert_xywh_to_ltrb():
    box = torch.tensor([0.5, 0.4, 0.2, 0.6])
    assert [round(float(v), 6) for v in pm.convert_xywh_to_ltrb(box)] == [0.4, 0.1, 0.6, 0.7]
