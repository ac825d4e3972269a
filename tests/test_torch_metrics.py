"""The evaluation modules of the port against the JAX package, one by one:
LayoutNet at full width (d 256, 4 + 4 layers) with its three label
remaps, the host layout metrics, the Fréchet distance, the patch
compositing, the PIL banner renderer, the dataset's patch and
original-background decode, the label-space guards, the real-stats cache
and ``report_metric``. Same numpy inputs from a seed on both sides; JAX
params crossed over by the port's converters, and back by the JAX
package's ``torch_convert``."""

import json
import os

import numpy as np
import PIL.Image
import pytest
import torch

import jax

from layoutdetr_tpu.data.dataset import LayoutDataset as JaxDataset
from layoutdetr_tpu.metrics import compositing as jax_compositing
from layoutdetr_tpu.metrics import frechet as jax_frechet
from layoutdetr_tpu.metrics import layout_metrics as jax_lm
from layoutdetr_tpu.metrics import metric_main as jax_metric_main
from layoutdetr_tpu.models.layoutnet import LayoutNet as JaxLayoutNet
from layoutdetr_tpu.serving import render as jax_render
from layoutdetr_tpu.utils.torch_convert import convert_layoutnet
from layoutdetr_tpu_torch.data.dataset import LayoutDataset
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.metrics import compositing, frechet, layout_fid, metric_main
from layoutdetr_tpu_torch.metrics.layout_metrics import compute_docsim_weight, compute_iou
from layoutdetr_tpu_torch.models.layoutnet import LayoutNet
from layoutdetr_tpu_torch.serving import render
from layoutdetr_tpu_torch.utils.convert import layoutnet_state_dict_from_jax

from test_torch_common import assert_max_abs, load_port, random_params
from test_torch_common import jax_native_private  # noqa: F401 (module-scoped fixture)
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5


def _layout_inputs(num_label, b=3, n=9, seed=0):
    rng = np.random.default_rng(seed)
    bbox = rng.uniform(0.05, 0.95, size=(b, n, 4)).astype(np.float32)
    label = rng.integers(0, num_label, size=(b, n))
    pad = np.zeros((b, n), bool)
    pad[0, 3:] = True
    pad[1, 7:] = True
    return bbox, label, pad


@pytest.fixture(scope="module")
def layoutnet_case():
    bbox, label, pad = _layout_inputs(13)
    net = JaxLayoutNet(13)
    params = random_params(net, bbox, label, pad)
    return net, params, (bbox, label, pad)


@pytest.mark.parametrize("remap", [{}, {"label_idx_replace": True}, {"label_idx_replace_2": True}],
                         ids=["none", "ads", "cgl"])
def test_layoutnet_features_match_jax(layoutnet_case, remap):
    net, params, (bbox, label, pad) = layoutnet_case
    want = np.asarray(jax.jit(lambda *a: net.apply({"params": params}, *a, **remap,
                                                   method=net.extract_features))(bbox, label, pad))
    port = load_port(LayoutNet(13), layoutnet_state_dict_from_jax(params))
    with torch.inference_mode():
        got = port.extract_features(torch.from_numpy(bbox), torch.from_numpy(label),
                                    torch.from_numpy(pad), **remap)
    assert got.shape == (3, 256)
    assert_max_abs(got, want, TOL, f"LayoutNet features {remap}")


def test_layoutnet_heads_and_reference_names(layoutnet_case):
    """The forward's three heads match JAX, and the port's state dict is the
    reference's: the JAX package's converter reads it back into JAX's params
    (pos_token [50, 1, d], a 3-d token)."""
    net, params, (bbox, label, pad) = layoutnet_case
    want = jax.jit(lambda *a: net.apply({"params": params}, *a))(bbox, label, pad)
    port = load_port(LayoutNet(13), layoutnet_state_dict_from_jax(params))
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (bbox, label, pad)))
    for name, g, w in zip(("logit_disc", "logit_cls", "bbox_pred"), got, want):
        assert_max_abs(g, np.asarray(w), TOL, name)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert sd["pos_token"].shape == (50, 1, 256) and sd["enc_transformer.token"].shape == (1, 1, 256)
    back = convert_layoutnet(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    mine, theirs = flat(back), flat(params)
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_compute_iou_and_docsim_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0.0, 1.0, size=(64, 4))
    b = rng.uniform(0.0, 1.0, size=(64, 4))
    a[:4, 2] = 0.0  # zero-area boxes: 0/0 becomes 0
    b[:4, 2] = 0.0
    b[10:20] = a[10:20]  # identical pairs
    for ours, theirs in ((compute_iou, jax_lm.compute_iou),
                         (compute_docsim_weight, jax_lm.compute_docsim_weight)):
        got, want = ours(a, b), np.asarray(theirs(a, b, xp=np))
        assert got.dtype == np.float64 and np.isfinite(got).all()
        assert np.max(np.abs(got - want)) <= 1e-6, ours.__name__


def test_frechet_matches_jax():
    rng = np.random.default_rng(2)
    f1, f2 = rng.normal(size=(40, 8)), rng.normal(0.3, 1.2, size=(50, 8))
    s1, s2 = frechet.gaussian_stats(f1), frechet.gaussian_stats(f2)
    for x, y in zip(s1 + s2, jax_frechet.gaussian_stats(f1) + jax_frechet.gaussian_stats(f2)):
        np.testing.assert_array_equal(x, y)
    assert frechet.frechet_distance(*s1, *s2) == jax_frechet.frechet_distance(*s1, *s2)
    bad = s1[1].copy()
    bad[0, 0] = np.nan  # sqrtm never ends on NaN: the guard returns NaN first
    assert np.isnan(frechet.frechet_distance(s1[0], bad, *s2))


def _norm(u8):
    from layoutdetr_tpu_torch.data.dataset import normalize_image

    return normalize_image(u8)


def test_compositing_matches_jax():
    rng = np.random.default_rng(3)
    b, m = 3, 4
    bg = _norm(rng.integers(0, 255, (b, 48, 40, 3), np.uint8))
    patches = _norm(rng.integers(0, 255, (b, m, 40, 56, 3), np.uint8))
    real = rng.uniform(0.1, 0.9, size=(b, m, 4)).astype(np.float32)
    fake = rng.uniform(-0.1, 1.1, size=(b, m, 4)).astype(np.float32)  # overhang clipped
    mask = np.ones((b, m), bool)
    mask[1, 2:] = False
    args = (fake, real, patches, mask, bg, [120, 80, 100], [90, 120, 100])
    got = compositing.composite_batch(*args, size_canvas=96)
    want = jax_compositing.composite_batch(*args, size_canvas=96)
    assert got.shape == (3, 96, 96, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_render_banner_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    bg = PIL.Image.fromarray(rng.integers(0, 255, (120, 200, 3), np.uint8))
    boxes = np.array([[0.5, 0.2, 0.6, 0.15], [0.5, 0.5, 0.7, 0.2], [0.5, 0.8, 0.25, 0.1]], np.float32)
    masks = np.ones(3, bool)
    styles = [dict(metric_main._RENDER_SPECS[lab], text=t)
              for lab, t in ((0, "Summer sale"), (3, "Save big & more"), (5, "Shop now"))]
    for is_center in (True, False):
        ours = render.compose_banner_html(boxes, masks, styles, is_center, bg, "x.png")
        assert ours == jax_render.compose_banner_html(boxes, masks, styles, is_center, bg, "x.png")
        render.render_banner_pil(boxes, masks, styles, is_center, bg, str(tmp_path / "a.png"))
        jax_render.render_banner_pil(boxes, masks, styles, is_center, bg, str(tmp_path / "b.png"))
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "a.png")),
                                      np.asarray(PIL.Image.open(tmp_path / "b.png")))
    img, html = render.visualize_banner(boxes, masks, styles, True, bg, None, ["image"],
                                        str(tmp_path / "banner"))
    assert os.path.exists(img) and os.path.exists(html)
    with open(html) as f:
        again = render.rerender_html_pil(f.read(), str(tmp_path))
    assert again.size == bg.size


def test_dataset_patches_and_original_background_match_jax(tmp_path, jax_native_private):  # noqa: F811
    path = make_synthetic_zip(str(tmp_path / "val.zip"), num_samples=3, image_size=48,
                              max_elements=3, seed=5)
    kw = dict(background_size=32, max_text_length=16, load_patches=True, load_background_orig=True)
    ours, theirs = LayoutDataset(path, **kw), JaxDataset(path, **kw)
    assert ours._cache is None  # the full-resolution decode bypasses the sample cache
    got, want = ours.collate([0, 1, 2]), theirs.collate([0, 1, 2])
    # the 256^2 patches and masks JAX also decodes: no metric reads them
    assert got.keys() == want.keys() - {"patches", "patch_masks"}
    assert got["patches_orig"].shape == (3, 9, 32, 32, 3) and got["background_orig"].shape == (3, 48, 48, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain = LayoutDataset(path, background_size=32, max_text_length=16).collate([0])
    assert "patches_orig" not in plain and "W_page" not in plain  # off by default


class _FakeDS:
    name = ""  # no reference dataset name: the 5-label default
    num_bbox_labels = 8


def test_layoutnet_label_space_guards():
    """Out-of-range labels never reach the embedding: the random fallback
    widens to the dataset's labels, given weights define the label space
    and a label outside it raises (the JAX package's guards)."""
    device_anchor = torch.nn.Linear(1, 1)  # the metric's device: G_ema's
    bbox = np.random.RandomState(0).rand(2, 9, 4).astype(np.float32)
    label = np.full((2, 9), 7, np.int64)
    pad = np.zeros((2, 9), bool)
    feat, num_label = layout_fid._layoutnet(metric_main.MetricOptions(dataset=_FakeDS(), G=device_anchor))
    assert num_label == 8 and np.isfinite(feat(bbox, label, pad)).all()
    with torch.random.fork_rng():
        torch.manual_seed(1)
        sd5 = LayoutNet(5).state_dict()
    feat5, nl5 = layout_fid._layoutnet(metric_main.MetricOptions(dataset=_FakeDS(), G=device_anchor,
                                                                 layoutnet_params=sd5))
    assert nl5 == 5
    with pytest.raises(ValueError, match="out of range"):
        feat5(bbox, label, pad)
    assert np.isfinite(feat5(bbox, label - 3, pad)).all()


def test_real_stats_cache_lives_in_the_ports_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    opts = metric_main.MetricOptions(dataset=_FakeDS())
    path = layout_fid._real_stats_cache_path(opts, 6, 8)
    assert os.path.dirname(path) == str(tmp_path / ".cache" / "layoutdetr_tpu_torch")
    assert path != layout_fid._real_stats_cache_path(metric_main.MetricOptions(
        dataset=_FakeDS(), layoutnet_params={}), 6, 8)


def test_registry_and_report_metric_match_jax(tmp_path):
    assert metric_main.list_valid_metrics() == jax_metric_main.list_valid_metrics()
    assert not metric_main.is_valid_metric("nope")
    with pytest.raises(ValueError, match="unknown metric"):
        metric_main.calc_metric("nope")
    result = dict(results={"foo": 1.0}, metric="layout_fid50k_val", total_time=0.1,
                  total_time_str="0s")
    metric_main.report_metric(result, run_dir=str(tmp_path), snapshot_path="snap")
    metric_main.report_metric(result, run_dir=str(tmp_path), snapshot_path="snap2")
    lines = (tmp_path / "metric-layout_fid50k_val.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["snapshot_path"] for r in recs] == ["snap", "snap2"]
    assert recs[0]["results"] == {"foo": 1.0} and recs[0].keys() == {
        "results", "metric", "total_time", "total_time_str", "snapshot_path", "timestamp"}
