"""The port's multi-host path: ``python -m layoutdetr_tpu_torch.train`` under
torchrun as two "nodes" of one rank each on this host (``--nnodes 2
--node-rank {0,1} --nproc-per-node 1``, gloo on the CPU), against the
same run spawned by ``--device cpu --chips 2``: 2 steps, then a 2-step
resume from the snapshot. The stats lines (clock fields aside) and the
snapshots must be equal bit for bit; rank 0 alone writes the run
directory; ``--chips`` that disagrees with torchrun's world is an error.
JAX's counterpart is ``tests/test_multihost.py``. The CLI keeps ResNet50
and DETR full, so a snapshot is ~1.5 GB: each is reduced to a digest of
its tensors once read, and all are removed whatever the outcome."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.parallel.distributed import free_port
from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_parallel_cli import SMALL, TIMEOUT_S, _cli, _jsonl, _run_dirs, _snapshots_removed

# what a stats line holds of the host's clock and memory
CLOCK = ("timestamp", "sec_per_kimg", "maintenance", "cpumem_gb", "devmem_gb", "devmem_peak_gb",
         "main_step_s", "reg_step_s", "feed_s")
SNAPSHOT = "network-snapshot-000000.pt"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mhost")
    return make_synthetic_zip(str(d / "train.zip"), num_samples=8, image_size=32, max_elements=9,
                              seed=0, structured=True)


def _torchrun(args, timeout=TIMEOUT_S):
    """Two torchrun "nodes" of one rank each on 127.0.0.1, started
    together; node 0's stdout."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    env.pop("OMP_NUM_THREADS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank", str(node),
         "--nproc-per-node", "1", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "layoutdetr_tpu_torch.train", *args],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for node in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:] + err[-3000:]
    return outs[0][0]


def _files(run_dir):
    return sorted(n for n in os.listdir(run_dir) if not n.startswith("events.out.tfevents."))


def _lines(run_dir):
    return [{k: v for k, v in line.items() if k not in CLOCK and not k.startswith("Timing/")}
            for line in _jsonl(run_dir)]


def _same_lines(run, ref):
    got, want = _lines(run), _lines(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"line {i}: " + str({k: (g.get(k), v) for k, v in w.items() if g.get(k) != v})


def _digest(path, keep=False):
    """sha256 of every tensor and value of a snapshot, by name; then the
    file is removed unless ``keep`` (at most two ~1.5 GB snapshots stay on
    the disk)."""
    def sha(t):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        return f"{t.dtype} {tuple(t.shape)} " + hashlib.sha256(raw.numpy().tobytes()).hexdigest()

    snap = load_snapshot(path)
    out = {"step": snap["step"], "pl_mean": sha(snap["pl_mean"])}
    for key in ("G", "D", "G_ema"):
        for name, t in snap[key].items():
            out[f"{key}/{name}"] = sha(t)
    for key in ("opt_g", "opt_d"):
        for i, st in snap[key]["state"].items():
            for name, t in st.items():
                out[f"{key}[{i}].{name}"] = sha(t)
    del snap
    if not keep:
        os.remove(path)
    return out


def _same(got, want):
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []


def test_two_torchrun_nodes_train_and_resume_as_chips_2(data, tmp_path):
    """Node 0 and node 1 under torchrun give the stats lines and the
    snapshots of ``--chips 2``, through a resume; rank 0's files exist
    once, in one run directory."""
    with _snapshots_removed(tmp_path):
        base = ["--data", data, "--batch", "2", "--device", "cpu", *SMALL, "--aug", "ada",
                "--snap", "1"]
        spawned, launched = str(tmp_path / "spawned"), str(tmp_path / "torchrun")
        _cli(["--outdir", spawned, *base, "--chips", "2", "--max-steps", "2"])
        out = _torchrun(["--outdir", launched, *base, "--max-steps", "2"])
        assert "ranks (" in out and "Training done." in out
        (run,), (ref,) = _run_dirs(launched), _run_dirs(spawned)
        # the same files (the TensorBoard log is named by time and pid)
        assert _files(run) == _files(ref)
        with open(os.path.join(run, "training_options.json")) as f:
            assert json.load(f)["ranks"] == 2
        _same_lines(run, ref)
        snap = os.path.join(ref, SNAPSHOT)
        _same(_digest(os.path.join(run, SNAPSHOT)), _digest(snap, keep=True))

        # both resume from the spawned run's snapshot (equal to torchrun's)
        _cli(["--outdir", spawned, *base, "--chips", "2", "--max-steps", "2", "--resume", snap])
        ref2 = _run_dirs(spawned)[1]
        want = _digest(os.path.join(ref2, SNAPSHOT))
        out = _torchrun(["--outdir", launched, *base, "--gpus", "2", "--max-steps", "2",
                         "--resume", snap])
        assert f"Resumed from {snap}" in out
        run2 = _run_dirs(launched)[1]
        _same_lines(run2, ref2)
        got = _digest(os.path.join(run2, SNAPSHOT))
        assert got["step"] == 4
        _same(got, want)


def test_chips_that_disagree_with_torchrun_are_an_error(data, tmp_path):
    """``--chips 3`` under a 2-rank torchrun stops before training."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    proc = subprocess.run([sys.executable, "-m", "layoutdetr_tpu_torch.train", "--outdir",
                           str(tmp_path), "--data", data, "--batch", "2", "--device", "cpu",
                           "--chips", "3", *SMALL], cwd=REPO_ROOT, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 2
    assert "--chips 3, but torchrun started 2 ranks" in proc.stderr
    assert not os.listdir(tmp_path)
