"""The production-dims parity driver's comparison, run at tiny dims so the
standalone driver (``tests/_torch_full_dims_driver.py``) cannot rot: the
same inputs, random JAX params crossed over, G and D at ``reconst=True``
and one deterministic train step, every output within the driver's bars
(and here within 1e-5, the tiny-dims bar of the other port tests); then
the ViT G and D (the ViT patched to width 16, depth 2 on both sides, as in
test_torch_vit.py), the LayoutGAN++ pair, and a JAX train state carried
into the port through ``tools/orbax_to_port.py`` (the orbax case)."""

import pytest

import _torch_full_dims_driver as driver

from test_torch_common import TINY_KW
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_vit import narrow_vit  # noqa: F401 (the ViT patched narrow on both sides)

DIMS = {**{k: v for k, v in TINY_KW.items() if k != "backbone_stage_sizes"},
        "backbone_stage_sizes": (1, 1, 1, 1), "reconst_decoder_layers": 1,
        "uncond_encoder_layers": 1}
LGPP_DIMS = {**TINY_KW, "max_text_length": 40, "bert_max_position_embeddings": 64, "f_dim": 16,
             "num_heads": 2, "num_layers": 2}


def test_compare_at_tiny_dims():
    rows = driver.compare(DIMS, log=lambda s: None)
    names = [r["name"] for r in rows]
    assert names[:5] == ["G bbox_fake", "G loss_z", "G logit_cls[valid]", "G loss_lm",
                         "G loss_text_len"]
    assert "D bg_rec" in names and "D bbox_rec[valid]" in names
    assert sum(n.startswith("step ") for n in names) >= 8
    assert all(r["ok"] for r in rows), driver.table(rows)
    worst = {r["name"]: r["max_abs"] for r in rows if r["max_abs"] > 1e-5 * max(1.0, r["scale"])}
    assert not worst, worst
    assert "| D bg_rec |" in driver.table(rows)


@pytest.mark.parametrize("model,first", [
    ("vit", ["vit G bbox_fake", "vit G loss_z"]),
    ("layoutganpp", ["layoutganpp G bbox_fake", "layoutganpp D logit",
                     "layoutganpp D bbox_pred[valid]", "layoutganpp D loss_lm",
                     "layoutganpp D bg_rec"]),
])
def test_new_models_compare_at_tiny_dims(narrow_vit, model, first):
    rows = driver.compare_models([model], DIMS, LGPP_DIMS, log=lambda s: None)
    names = [r["name"] for r in rows]
    assert names[:len(first)] == first and not any(n.startswith("vit step") for n in names)
    assert all(r["ok"] for r in rows), driver.table(rows)
    worst = {r["name"]: r["max_abs"] for r in rows if r["max_abs"] > 1e-5 * max(1.0, r["scale"])}
    assert not worst, worst


def test_orbax_case_at_tiny_dims():
    rows = driver.compare_models(["orbax"], DIMS, LGPP_DIMS, log=lambda s: None)
    names = [r["name"].split(" (")[0].split(",")[0] for r in rows]
    assert names == ["orbax G tensors off the converter's bits",
                     "orbax D tensors off the converter's bits",
                     "orbax G_ema tensors off the converter's bits",
                     "orbax next update G", "orbax next update D",
                     "orbax opt_g entries unlike a port step's",
                     "orbax opt_d entries unlike a port step's",
                     "orbax G_ema boxes", "orbax G_ema boxes"], names
    assert all(r["ok"] for r in rows), driver.table(rows)
    assert rows[-1]["name"] == "orbax G_ema boxes (--generator-only)"
    assert all(r["max_abs"] <= 1e-5 * max(1.0, r["scale"]) for r in rows[-2:]), driver.table(rows)
    assert min(r["scale"] for r in rows[:3] + rows[5:7]) > 10  # tensors and entries counted
