"""The ``train`` CLI's multi-GPU options on the CPU: ``--device cpu
--chips 2 --model-parallel 2`` (gloo ranks spawned by the CLI), run in a
subprocess with a deadline, with a resume from its snapshot; and
``--load-patches``. Data parallelism through ``training_loop`` is
``test_torch_parallel_loop``'s. The CLI builds the full ResNet50 and
DETR: each snapshot is ~1.5 GB, removed whatever the outcome."""

import contextlib
import glob
import json
import os
import subprocess
import sys

import pytest

from layoutdetr_tpu_torch import train as port_train
from layoutdetr_tpu_torch.data import dataset as port_dataset
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TIMEOUT_S = 300  # a run's deadline: a hung collective fails its test
SMALL = ["--bert-f-dim", "32", "--bert-num-heads", "2", "--bert-num-encoder-layers", "2",
         "--bert-num-decoder-layers", "1", "--im-f-dim", "16", "--background-size", "32",
         "--max-text-length", "auto", "--metrics", "none", "--workers", "0"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pcli")
    return make_synthetic_zip(str(d / "train.zip"), num_samples=8, image_size=32, max_elements=9,
                              seed=0, structured=True)


def _jsonl(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli(args, timeout=TIMEOUT_S):
    """``python -m layoutdetr_tpu_torch.train`` in a subprocess; its stdout."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-m", "layoutdetr_tpu_torch.train", *args],
                          cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _run_dirs(outdir):
    return sorted(os.path.join(outdir, d) for d in os.listdir(outdir))


@contextlib.contextmanager
def _snapshots_removed(root):
    """Remove every ``.pt`` under ``root`` on the way out."""
    try:
        yield
    finally:
        for path in glob.glob(os.path.join(str(root), "**", "*.pt"), recursive=True):
            os.remove(path)


@pytest.mark.parametrize("model_parallel", [2], ids=["tp2"])
def test_cli_trains_over_two_cpu_ranks_and_resumes(data, tmp_path, model_parallel):
    """``--device cpu --chips 2 --model-parallel 2`` trains, rank 0 writes
    one stats.jsonl, log.txt and the snapshot of the full tensors; a
    resume from that snapshot restores each rank's slices and trains on."""
    with _snapshots_removed(tmp_path):
        _train_and_resume(data, str(tmp_path / "runs"), model_parallel)


def _train_and_resume(data, outdir, model_parallel):
    base = ["--outdir", outdir, "--data", data, "--batch", "2", "--device", "cpu", "--chips", "2",
            "--model-parallel", str(model_parallel), *SMALL]
    out = _cli([*base, "--aug", "ada", "--gamma", "1", "--pl-weight", "2", "--snap", "1",
                "--max-steps", "2"])
    assert "ranks (" in out and "Training done." in out
    (run_dir,) = _run_dirs(outdir)
    with open(os.path.join(run_dir, "training_options.json")) as f:
        opts = json.load(f)
    assert opts["ranks"] == 2 and opts["model_parallel"] == model_parallel
    lines = _jsonl(run_dir)
    assert sum(ln["Loss/G/loss_Ggen"]["num"] for ln in lines) == 2 * 2  # 2 ranks, 2 steps
    with open(os.path.join(run_dir, "log.txt")) as f:
        assert sum(line.startswith("tick ") for line in f) == len(lines)
    snap = os.path.join(run_dir, "network-snapshot-000000.pt")
    assert load_snapshot(snap)["step"] == 2

    out = _cli([*base, "--resume", snap, "--max-steps", "1", "--snap", "1"])
    assert f"Resumed from {snap}" in out
    resumed = os.path.join(_run_dirs(outdir)[1], "network-snapshot-000000.pt")
    assert load_snapshot(resumed)["step"] == 3


def test_cli_load_patches_feeds_the_patches(data, tmp_path, monkeypatch):
    """``--load-patches``: the host loader decodes every batch's patches
    (auto turns the device feed off) and hands the step its batches
    without them, since no loss reads them; 2 steps, the loader on a
    thread so that its decodes are seen here."""
    decoded, fed = [], []
    collate, real_next = port_dataset.LayoutDataset.collate, port_dataset.PrefetchLoader.__next__

    def collate_batch(self, indices):
        batch = collate(self, indices)
        decoded.append(batch["patches_orig"].shape)
        return batch

    def next_batch(self):
        batch = real_next(self)
        fed.append("patches_orig" in batch)
        return batch

    monkeypatch.setattr(port_dataset.LayoutDataset, "collate", collate_batch)
    monkeypatch.setattr(port_dataset.PrefetchLoader, "__next__", next_batch)
    with _snapshots_removed(tmp_path):
        state = port_train.main(["--outdir", str(tmp_path), "--data", data, "--batch", "2",
                                 "--device", "cpu", "--load-patches", "--max-steps", "2",
                                 "--snap", "1", "--workers", "0", *SMALL])
    assert state.step == 2
    batches = [shape for shape in decoded if shape[0] == 2]
    assert len(batches) >= 2 and set(batches) == {(2, 9, 32, 32, 3)}  # the zip's 32^2 patches
    assert fed == [False] * 2
