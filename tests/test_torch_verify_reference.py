"""The port's reference-artifact closure (``python -m
layoutdetr_tpu_torch.verify_reference``) against the JAX package's chain
(``tools/verify_reference_artifacts.py``: ``load_generator_checkpoint`` of
the pickle, then ``Generator.apply``): the digest forward on the same
pickle, the same val batch and the same z (fp32, 1e-5 max-abs); and the
dry run end to end on the CPU at a tiny config, which writes the digest,
one finite line per metric and ``OUT/PARITY.md``, and leaves
``docs/PARITY.md`` as it was."""

import hashlib
import json
import os
import pickle

import numpy as np
import torch

from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.utils.checkpoint import load_generator_checkpoint as jax_load
from layoutdetr_tpu_torch import verify_reference
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.dataset import LayoutDataset
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.utils.checkpoint import generator_from_network_pkl
from layoutdetr_tpu_torch.utils.legacy_pkl import load_network_pkl

from test_torch_common import REPO_ROOT, assert_max_abs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5
# The G of both tests: only what a snapshot's weights tell is narrowed
# (JAX's converter reads the reference's full ResNet50 and 6 + 6 DETR
# layers), so that a loader infers it from the pickle; the background size
# is not in a snapshot and goes in as a default.
TINY = dict(hidden_dim=16, bert_f_dim=32, bert_num_encoder_layers=2, bert_num_decoder_layers=1,
            max_text_length=16, bert_intermediate_size=64, bert_max_position_embeddings=32,
            background_size=32)


def test_digest_forward_matches_jax_on_the_same_pickle(tmp_path, monkeypatch):
    """The closure's G from a pkl_snapshot-style pickle and its forward at
    a given z, against JAX's loader and apply on the same file and z."""
    cfg = GeneratorConfig(**TINY)
    torch.manual_seed(5)
    G = Generator(cfg).eval()
    pkl = str(tmp_path / "snapshot.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(dict(G=None, D=None, G_ema=G, augment_pipe=None,
                         training_set_kwargs={"path": "train.zip", "max_elements": 9}), f)
    monkeypatch.setenv("LAYOUTDETR_BERT_VOCAB", verify_reference.make_vocab(str(tmp_path)))
    data = make_synthetic_zip(str(tmp_path / "val.zip"), num_samples=6, image_size=32,
                              max_elements=9, seed=1, structured=True)

    port = generator_from_network_pkl(load_network_pkl(pkl), "cpu", background_size=32)
    assert port.cfg == cfg
    dataset = LayoutDataset(data, background_size=32, max_text_length=cfg.max_text_length,
                            text_len_clip=cfg.text_len_table)
    dataset.tokenizer.require_hf_for_checkpoint(pkl)  # a vocab is there: no refusal
    batch = dataset.collate(list(range(4)))
    z = verify_reference.fixed_z(4, cfg)
    got = verify_reference.fixed_seed_forward(port, batch, z)

    params, jcfg = jax_load(pkl, background_size=32)
    want = np.asarray(JaxGenerator(jcfg).apply(
        params, z=z.numpy(), bbox_real=batch["bboxes"], bbox_class=batch["labels"],
        text_ids=batch["text_ids"], text_mask=batch["text_mask"], text_len=batch["text_len"],
        padding_mask=~batch["mask"], background=batch["background"]))
    assert got.shape == want.shape == (4, 9, 4) and np.isfinite(got).all()
    assert_max_abs(got, want, TOL, "digest forward bbox")
    assert verify_reference.digest(got) == verify_reference.digest(got.copy())


def test_dry_run_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``--dry-run`` at a tiny config: the pickle read, the digest saved, a
    finite line for each metric, the report in OUT, docs/PARITY.md as it
    was."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # the layout FID's stats cache
    # the closure points the tokenizer at its vocab; restored after the test
    monkeypatch.setenv("LAYOUTDETR_BERT_VOCAB", str(tmp_path / "no_vocab"))
    docs = os.path.join(REPO_ROOT, "docs", "PARITY.md")
    with open(docs, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    out = str(tmp_path / "out")
    res = verify_reference.main(["--dry-run", out, "--device", "cpu", "--dry-run-items", "6",
                                 "--dry-run-config", json.dumps(TINY)])
    with open(docs, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before

    saved = np.load(os.path.join(out, "bbox_fixed_seed.npz"))
    assert saved["bbox"].shape == (4, 9, 4) and np.isfinite(saved["bbox"]).all()
    np.testing.assert_array_equal(saved["z"], verify_reference.fixed_z(4, GeneratorConfig()).numpy())
    assert res["digest"] == verify_reference.digest(saved["bbox"])
    assert res["config"]["bert_f_dim"] == 32 and res["n_tensors"] > 100
    for metric in verify_reference.METRICS_REAL.split(","):
        with open(os.path.join(out, f"metric-{metric}.jsonl")) as f:
            (line,) = [json.loads(x) for x in f]
        assert line["results"] and all(np.isfinite(v) for v in line["results"].values()), metric
    assert set(res["results"]) == {"layout_fid50k_val", "fid50k_val", "overlap50k_val",
                                   "alignment50k_val", "layoutwise_iou50k_val",
                                   "layoutwise_docsim50k_val"}
    with open(os.path.join(out, "PARITY.md")) as f:
        report = f.read()
    assert "DRY RUN" in report and res["digest"] in report and "FALLBACK" in report
    assert "wordpiece tokenizer" in report
