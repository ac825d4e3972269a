"""The multi-GPU training run on the CPU: ``training_loop`` over 2 gloo
ranks (spawned processes, each run with a deadline) with ADA and both
regularizers, and its resume."""

import json
import os

import pytest
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.training.loss import LossWeights
from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot

import _torch_parallel_worker as worker
from test_torch_common import TINY_KW
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

# the tokenizer emits real BERT-range ids: the full vocab at width 32
CFG = GeneratorConfig(**{**TINY_KW, "vocab_size": 30524, "bos_token_id": 30522,
                         "reconst_decoder_layers": 1, "uncond_encoder_layers": 1})
STEPS = 5  # ADA moves p at batch 4; path length at 0, 2, 4; R1 at 0, 4
TIMEOUT_S = 300  # a spawned run's deadline: a hung collective fails its test

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ploop")
    return make_synthetic_zip(str(d / "train.zip"), num_samples=8, image_size=32, max_elements=9,
                              seed=0, structured=True)


def _loop(tmp, data, **kw):
    """``training_loop`` over 2 ranks in ``tmp``; each rank's record."""
    args = dict(run_dir=tmp, data=data, gcfg=CFG, loss_weights=LossWeights(pl_weight=2.0, r1_gamma=1.0),
                batch_size=4, g_reg_interval=2, d_reg_interval=4, kimg_per_tick=1,
                network_snapshot_ticks=1, image_snapshot_ticks=1, aug="ada", device="cpu")
    args.update(kw)
    spec = os.path.join(tmp, "spec.pt")
    torch.save(dict(kwargs=args), spec)
    distributed.spawn(worker.loop_case, 2, (spec, tmp), devices=["cpu", "cpu"],
                      timeout_s=TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def _jsonl(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("ranks"))
    return run_dir, _loop(run_dir, data, max_steps=STEPS, device_feed="on")


def test_two_ranks_train_with_ada_and_both_regularizers(two_ranks):
    run_dir, recs = two_ranks
    assert [r["step"] for r in recs] == [STEPS, STEPS]
    # ADA's p moves by the sign averaged over the ranks: one p on both
    assert recs[0]["ada_p"] and recs[0]["ada_p"] == recs[1]["ada_p"]
    assert recs[0]["pl_mean"] == recs[1]["pl_mean"] > 0
    lines = _jsonl(run_dir)  # rank 0's alone: a tick after step 1, then the last
    assert len(lines) == 2
    # the collector sums both ranks' stats: two reports a step
    assert [ln["Loss/G/loss_Ggen"]["num"] for ln in lines] == [2, 2 * (STEPS - 1)]
    assert sum(ln["Loss/G/reg"]["num"] for ln in lines) == 2 * 3
    assert sum(ln["Loss/D/reg"]["num"] for ln in lines) == 2 * 2
    assert lines[-1]["ada_updates"] == 1
    names = os.listdir(run_dir)
    assert [n for n in names if n.endswith(".pt") and n.startswith("network")] == [
        "network-snapshot-000000.pt"]
    assert "fakes000000_0.png" in names
    snap = load_snapshot(os.path.join(run_dir, "network-snapshot-000000.pt"))
    assert snap["step"] == STEPS


def test_two_ranks_resume_continues(two_ranks, data, tmp_path):
    run_dir, _ = two_ranks
    snap = os.path.join(run_dir, "network-snapshot-000000.pt")
    recs = _loop(str(tmp_path), data, resume=snap, max_steps=2, device_feed="off", num_workers=0,
                 module_summary=False)
    assert [r["step"] for r in recs] == [STEPS + 2, STEPS + 2]
    assert len(_jsonl(str(tmp_path))) == 2
