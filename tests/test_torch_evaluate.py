"""The evaluation slice as a whole against the JAX package's ``calc_metric``:
a tiny Generator (the dims of ``TINY_KW``, the full BERT vocabulary) with
JAX params crossed over, on a 6-sample synthetic zip read by both
packages' datasets, LayoutNet and Inception weights crossed over too, and
the port's noise replaced by JAX's draws. Then the port's two entry
points on the CPU: ``python -m layoutdetr_tpu_torch.evaluate`` (one
snapshot and a sweep) and the training CLI with metrics at its snapshot
ticks, and both refusing to run without a card unless ``--device cpu``
is given."""

import json
import os

import numpy as np
import PIL.Image
import pytest
import torch

import jax

from layoutdetr_tpu.data.dataset import LayoutDataset as JaxDataset
from layoutdetr_tpu.metrics import image_fid as jax_image_fid
from layoutdetr_tpu.metrics import layout_fid as jax_layout_fid
from layoutdetr_tpu.metrics import metric_main as jax_metric_main
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.layoutnet import LayoutNet as JaxLayoutNet
from layoutdetr_tpu_torch import evaluate
from layoutdetr_tpu_torch import train as port_train
from layoutdetr_tpu_torch.data.dataset import LayoutDataset
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.generate import save_generator
from layoutdetr_tpu_torch.metrics import image_fid, layout_fid, metric_main
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.utils.convert import (
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
    layoutnet_state_dict_from_jax,
)

from test_torch_common import load_port, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_inception import inception_params

SUITE = "overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val"
SUITE_TOL = 1e-5
STATS_TOL = 1e-5  # of the largest |statistic|
BATCH = 4  # 6 samples: a full batch and a partial one


def _jax_z_draws(seed, shape):
    """JAX's generate_layouts noise: split the seed's key, one normal draw a batch."""
    state = {"rng": jax.random.PRNGKey(seed)}

    def draw(n):
        state["rng"], zk = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(jax.random.normal(zk, (n,) + tuple(shape))))

    return draw


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    zip_path = make_synthetic_zip(str(d / "val.zip"), num_samples=6, image_size=32, max_elements=3)
    jcfg, cfg = tiny_configs(vocab_size=30524, bos_token_id=30522)
    jds = JaxDataset(zip_path, background_size=32, max_text_length=16)
    ds = LayoutDataset(zip_path, background_size=32, max_text_length=16)
    b = jds.collate([0])
    g = JaxGenerator(jcfg)
    g_params = random_params(g, z=np.zeros((1, 9, jcfg.z_dim), np.float32), bbox_real=b["bboxes"],
                             bbox_class=b["labels"], text_ids=b["text_ids"], text_mask=b["text_mask"],
                             text_len=b["text_len"], padding_mask=b["padding_mask"],
                             background=b["background"], reconst=True)
    ln_params = random_params(JaxLayoutNet(8), b["bboxes"], b["labels"], b["padding_mask"])
    inc_params = inception_params()
    port = dict(G=load_port(Generator(cfg), generator_state_dict_from_jax(g_params, cfg)),
                dataset=ds, layoutnet_params=layoutnet_state_dict_from_jax(ln_params),
                inception_params=inception_state_dict_from_jax(inc_params))
    jax_kw = dict(g_apply=jax.jit(g.apply), params={"params": g_params}, dataset=jds, gcfg=jcfg,
                  layoutnet_params={"params": ln_params}, inception_params=inc_params)
    common = dict(batch=BATCH, seed=0, cache_real_stats=False, size_canvas=299)
    return dict(port=port, jax=jax_kw, common=common, zip=zip_path, cfg=cfg, dir=d)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(layout_fid, "z_draws", _jax_z_draws)


def _recorded_stats(monkeypatch, module):
    """Record the Gaussian statistics each call of ``module.frechet_distance`` gets."""
    seen, real = [], module.frechet_distance

    def record(mu1, s1, mu2, s2, *a, **kw):
        seen.append((mu1, s1, mu2, s2))
        return real(mu1, s1, mu2, s2, *a, **kw)

    monkeypatch.setattr(module, "frechet_distance", record)
    return seen


def _assert_stats_close(ours, theirs, what):
    assert len(ours) == len(theirs) == 1
    for got, want in zip(ours[0], theirs[0]):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= STATS_TOL * scale, what


def _both(case, metric):
    ours = metric_main.calc_metric(metric, **case["port"], **case["common"])
    theirs = jax_metric_main.calc_metric(metric, **case["jax"], **case["common"])
    return ours["results"], theirs.results


def test_layout_fid_matches_jax(case, jax_noise, monkeypatch):
    """The Gaussian statistics of the real and the generated LayoutNet
    features agree to 1e-5; the FID itself to 1e-3 relative."""
    ours_seen = _recorded_stats(monkeypatch, layout_fid)
    theirs_seen = _recorded_stats(monkeypatch, jax_layout_fid)
    ours, theirs = _both(case, "layout_fid50k_val")
    _assert_stats_close(ours_seen, theirs_seen, "layout FID statistics")
    got, want = ours["layout_fid50k_val"], theirs["layout_fid50k_val"]
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want)


def test_eval_suite_matches_jax(case, jax_noise):
    ours, theirs = _both(case, SUITE)
    assert ours.keys() == theirs.keys() == {"overlap50k_val", "alignment50k_val",
                                            "layoutwise_iou50k_val", "layoutwise_docsim50k_val"}
    for k in ours:
        assert np.isfinite(ours[k]) and abs(ours[k] - theirs[k]) <= SUITE_TOL, k


def _recorded_features(monkeypatch, module):
    """Record every feature array ``module``'s image-FID feature fn returns."""
    seen, real = [], module._feature_fn

    def feature_fn(opts):
        fn = real(opts)

        def record(imgs):
            out = np.asarray(fn(imgs))
            seen.append(out)
            return out

        return record

    monkeypatch.setattr(module, "_feature_fn", feature_fn)
    return seen


def test_image_fid_matches_jax(case, jax_noise, monkeypatch):
    """Patch compositing + converted Inception weights, 3 samples. The FID
    is not compared: with so few samples the 2048-d covariances are
    singular, sqrtm is ill-conditioned (and takes ~25 s a call here), so
    ``frechet_distance`` (equal to JAX's on the same statistics, see
    test_torch_metrics) is stubbed on both sides and the comparison is on
    what it is given. The Inception features agree to 1e-5 of max |f| and
    the means to 1e-5. The covariances are ~1e-6 beside features of ~0.8,
    below the features' fp32 resolution, so they are held to what the
    features' difference d allows: |d sigma| <= 2 d s + d^2, s the largest
    deviation of a feature from its mean."""
    stats = {}
    feats = {}
    for tag, module in (("port", image_fid), ("jax", jax_image_fid)):
        stats[tag] = []
        feats[tag] = _recorded_features(monkeypatch, module)
        monkeypatch.setattr(module, "frechet_distance",
                            lambda *a, seen=stats[tag]: seen.append(a) or 0.0)
    kw = dict(case["common"], batch=3, max_items=3)
    metric_main.calc_metric("fid50k_val", **case["port"], **kw)
    jax_metric_main.calc_metric("fid50k_val", **case["jax"], **kw)
    assert len(feats["port"]) == len(feats["jax"]) == 2  # real and fake, one batch
    d = 0.0
    for got, want in zip(feats["port"], feats["jax"]):
        assert got.shape == (3, 2048) and np.isfinite(got).all()
        d = max(d, np.abs(got - want).max())
        assert d <= 1e-5 * np.abs(want).max()
    (mu_f, sig_f, mu_r, sig_r), (jmu_f, jsig_f, jmu_r, jsig_r) = stats["port"][0], stats["jax"][0]
    s = max(np.abs(f - f.mean(0)).max() for f in feats["jax"])
    for got, want in ((mu_f, jmu_f), (mu_r, jmu_r)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for got, want in ((sig_f, jsig_f), (sig_r, jsig_r)):
        assert np.abs(got - want).max() <= 2 * d * s + d * d


def test_rendering_val_writes_the_files_jax_writes(case, jax_noise, tmp_path):
    ours = metric_main.calc_metric("rendering_val", **case["port"], **case["common"],
                                   render_dir=str(tmp_path / "port"))["results"]
    theirs = jax_metric_main.calc_metric("rendering_val", **case["jax"], **case["common"],
                                         render_dir=str(tmp_path / "jax")).results
    assert ours["rendering_val"] == theirs["rendering_val"] > 0
    for kind in ("rendering_fake", "rendering_real"):
        names = sorted(os.listdir(tmp_path / "port" / kind))
        assert names == sorted(os.listdir(tmp_path / "jax" / kind))
        assert sum(n.endswith("_vis.png") for n in names) == ours["rendering_val"]
        for n in names:
            a, b = tmp_path / "port" / kind / n, tmp_path / "jax" / kind / n
            if n.endswith(".html"):
                assert a.read_text() == b.read_text(), n
            else:
                np.testing.assert_array_equal(np.asarray(PIL.Image.open(a)),
                                              np.asarray(PIL.Image.open(b)), err_msg=n)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_evaluate_cli_on_the_cpu(case, tmp_path, monkeypatch):
    """One snapshot, then a sweep of two by a glob; the dataset is
    re-tokenized to the checkpoint's T (16); a sweep that mixes
    architectures is refused."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the real-stats cache
    G = case["port"]["G"]
    for name in ("g0.pt", "g1.pt"):
        save_generator(G, str(tmp_path / name))
    torch.save(case["port"]["layoutnet_params"], tmp_path / "layoutnet.pth")
    argv = ["--data", case["zip"], "--device", "cpu", "--batch", str(BATCH),
            "--layoutnet-ckpt", str(tmp_path / "layoutnet.pth")]
    results = evaluate.main(["--ckpt", str(tmp_path / "g0.pt"), "--run-dir", str(tmp_path), *argv])
    assert [r["metric"] for r in results] == ["layout_fid50k_val", SUITE]
    assert all(np.isfinite(v) for r in results for v in r["results"].values())
    assert len(_lines(tmp_path / "metric-layout_fid50k_val.jsonl")) == 1
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    evaluate.main(["--ckpt", str(tmp_path / "g*.pt"), "--run-dir", str(sweep),
                   "--metrics", "layout_fid50k_val", *argv])
    lines = _lines(sweep / "metric-layout_fid50k_val.jsonl")
    assert [os.path.basename(r["snapshot_path"]) for r in lines] == ["g0.pt", "g1.pt"]
    assert lines[0]["results"] == lines[1]["results"]  # the same weights
    other = Generator(tiny_configs(vocab_size=30524, bos_token_id=30522, hidden_dim=8)[1])
    save_generator(other, str(tmp_path / "g2.pt"))
    with pytest.raises(SystemExit):
        evaluate.main(["--ckpt", str(tmp_path / "g*.pt"), "--run-dir", str(sweep),
                       "--metrics", "layout_fid50k_val", *argv])


def test_training_cli_runs_metrics_at_snapshot_ticks(tmp_path, monkeypatch):
    """``--metrics layout_fid50k_val --snap 1``: one line a snapshot tick,
    on the val.zip beside train.zip, tokenized at the run's T."""
    monkeypatch.setenv("HOME", str(tmp_path))
    data = make_synthetic_zip(str(tmp_path / "train.zip"), num_samples=4, image_size=32,
                              max_elements=4, seed=1, structured=True)
    make_synthetic_zip(str(tmp_path / "val.zip"), num_samples=3, image_size=32, max_elements=4,
                       seed=2, structured=True)
    port_train.main(["--outdir", str(tmp_path / "runs"), "--data", data, "--batch", "2",
                     "--device", "cpu", "--bert-f-dim", "32", "--bert-num-heads", "2",
                     "--bert-num-encoder-layers", "2", "--bert-num-decoder-layers", "1",
                     "--im-f-dim", "16", "--background-size", "32", "--max-text-length", "auto",
                     "--metrics", "layout_fid50k_val", "--snap", "1", "--max-steps", "2"])
    (run,) = os.listdir(tmp_path / "runs")
    run_dir = tmp_path / "runs" / run
    lines = _lines(run_dir / "metric-layout_fid50k_val.jsonl")
    snaps = sorted(n for n in os.listdir(run_dir) if n.endswith(".pt"))
    assert len(lines) == 2 and len(snaps) == 1  # two ticks, both at kimg 0
    assert all(np.isfinite(r["results"]["layout_fid50k_val"]) for r in lines)
    assert all(r["snapshot_path"].endswith(snaps[0]) for r in lines)


@pytest.mark.parametrize("entry", ["evaluate", "train"])
def test_entry_points_refuse_without_a_card(entry, case, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        if entry == "evaluate":
            evaluate.main(["--ckpt", "g.pt", "--data", case["zip"]])
        else:
            port_train.main(["--outdir", str(tmp_path), "--data", case["zip"], "--batch", "2"])
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
