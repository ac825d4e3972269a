"""The port's long-run and rehearsal launchers on the CPU at tiny widths.

``tools/run_stability_torch.sh`` trains in the background until
``tools/stop_stability_torch.sh`` stops it (after a file handshake: the
run's ``log.txt``, written once the trainer's SIGTERM handler is in
place), then resumes with ``STAB_RESUME``; ``tools/stability_report.py``
reads both run directories; ``tools/run_production_rehearsal_torch.sh``
makes 3 pages, converts them and trains 1 step. Every launcher runs in a
subprocess with a deadline, the rehearsal beside the stability pieces
(it starts with the module). The CLI builds the full ResNet50 and DETR,
so each snapshot is ~1.5 GB: they are removed on the way out."""

import glob
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot, snapshot_digest

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOOLS = os.path.join(REPO_ROOT, "tools")
DEADLINE_S = 240  # a launcher's; a hung run fails its test
SMALL = ["--bert-f-dim", "32", "--bert-num-heads", "2", "--bert-num-encoder-layers", "2",
         "--bert-num-decoder-layers", "1", "--im-f-dim", "16", "--background-size", "32",
         "--max-text-length", "auto", "--device", "cpu"]
METRICS = ["layout_fid50k_val",
           "overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val"]
DRY_RUN_NAMES = ("network-snapshot-000025.pt", "network-snapshot-000008.pt")


def _env(root, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("STAB_", "REH_"))}
    # TensorBoard's writer imports TensorFlow where it is installed (~10 s a
    # process on a CPU host) and else writes through its own stub: a
    # TensorFlow that fails to import keeps the runs on the stub.
    no_tf = root / "no_tensorflow"
    os.makedirs(no_tf / "tensorflow", exist_ok=True)
    (no_tf / "tensorflow" / "__init__.py").write_text("raise ImportError('not for these runs')\n")
    # two torch threads a trainer: the suite runs several test processes
    env.update(HOME=str(root / "home"), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(no_tf), REPO_ROOT]), **extra)
    return env


def _launch(script, env, log_path, *args):
    with open(log_path, "w") as log:
        return subprocess.Popen(["bash", os.path.join(TOOLS, script), *args], cwd=REPO_ROOT,
                                env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait(proc, log_path, deadline_s=DEADLINE_S):
    try:
        rc = proc.wait(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    with open(log_path) as f:
        return rc, f.read()


def _remove_snapshots(root):
    for path in glob.glob(os.path.join(str(root), "**", "*.pt"), recursive=True):
        os.remove(path)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _tiny_zips(out):
    """The launcher's data path with tiny zips in place of its 1024 + 128 samples."""
    os.makedirs(out / "data")
    make_synthetic_zip(str(out / "data" / "train.zip"), num_samples=8, image_size=32,
                       max_elements=9, seed=1, structured=True)
    make_synthetic_zip(str(out / "data" / "val.zip"), num_samples=4, image_size=32,
                       max_elements=9, seed=2, structured=True)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The launcher runs that need no other, started with the module beside
    the stability pieces; each test that reads one waits for it: the
    rehearsal at 3 pages and 1 step, and dry runs of the stability launcher
    (the trainer prints its options and exits) with STAB_RESUME names and
    without --device."""
    root = tmp_path_factory.mktemp("started")
    _tiny_zips(root / "runs")
    procs = {}
    env = _env(root, REH_PAGES="3", REH_KIMG="1", REH_ROOT=str(root / "reh"),
               REH_OUT=str(root / "out"))
    # batch 4 and one loader worker: a batch's decoded 1024^2 patches are ~0.5 GB
    procs["rehearsal"] = _launch("run_production_rehearsal_torch.sh", env,
                                 root / "rehearsal.log", *SMALL, "--max-steps", "1",
                                 "--batch", "4", "--workers", "1")
    env = _env(root, STAB_OUTDIR=str(root / "runs"), STAB_PIDFILE=str(root / "dry.pid"))
    for name in DRY_RUN_NAMES:
        procs[name] = _launch("run_stability_torch.sh", dict(env, STAB_RESUME=str(root / name)),
                              root / f"{name}.log", *SMALL, "--dry-run")
    procs["card"] = _launch("run_stability_torch.sh", env, root / "card.log", "--dry-run")
    try:
        yield dict(root=root, procs=procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _remove_snapshots(root)


def _result(started, name):
    return _wait(started["procs"][name], started["root"] / f"{name}.log")


@pytest.fixture(scope="module")
def stability(tmp_path_factory):
    """Piece 1 stopped by the stop tool at its first tick, piece 2 resumed
    from its snapshot for 1 step."""
    root = tmp_path_factory.mktemp("stability")
    out = root / "runs"
    _tiny_zips(out)
    env = _env(root, STAB_OUTDIR=str(out), STAB_PIDFILE=str(root / "train.pid"))
    try:
        log1 = root / "piece1.log"
        proc = _launch("run_stability_torch.sh", env, log1, *SMALL, "--max-steps", "3")
        end = time.monotonic() + DEADLINE_S
        while not glob.glob(str(out / "0*" / "log.txt")):
            assert proc.poll() is None, open(log1).read()[-3000:]
            assert time.monotonic() < end, "no log.txt from piece 1"
            time.sleep(0.2)
        stop = subprocess.run(["bash", os.path.join(TOOLS, "stop_stability_torch.sh")],
                              env=env, capture_output=True, text=True, timeout=DEADLINE_S)
        rc1, text1 = _wait(proc, log1)
        (run1,) = glob.glob(str(out / "0*"))
        snap = os.path.join(run1, "network-snapshot-000000.pt")

        log2 = root / "piece2.log"
        rc2, text2 = _wait(_launch("run_stability_torch.sh", dict(env, STAB_RESUME=snap), log2,
                                   *SMALL, "--max-steps", "1"), log2)
        (run2,) = sorted(set(glob.glob(str(out / "0*"))) - {run1})
        yield dict(root=root, env=env, stop=stop, rc1=rc1, text1=text1, run1=run1, snap=snap,
                   rc2=rc2, text2=text2, run2=run2, digest=snapshot_digest(load_snapshot(snap)))
    finally:
        _remove_snapshots(root)


def test_stop_snapshots_and_exits_through_sigterm(stability):
    s = stability
    assert s["stop"].returncode == 0 and "stopped." in s["stop"].stdout, s["stop"].stdout
    assert s["rc1"] == 0, s["text1"][-3000:]
    assert "SIGTERM: finishing tick, snapshotting" in s["text1"]
    assert "Training done." in s["text1"]
    # stopped at its first tick, before --max-steps 3 ended it
    (line,) = _jsonl(os.path.join(s["run1"], "stats.jsonl"))
    assert line["tick"] == 0 and line["kimg"] == 0.016
    assert os.path.isfile(s["snap"]) and os.path.isfile(s["snap"] + ".gcfg.json")
    assert not os.path.exists(s["env"]["STAB_PIDFILE"])


def test_launcher_passes_the_jax_flags_and_no_reg_steps(stability):
    with open(os.path.join(stability["run1"], "training_options.json")) as f:
        opts = json.load(f)
    assert opts["batch_size"] == 16 and opts["bf16"] and opts["aug"] == "ada"
    assert opts["total_kimg"] == 200 and opts["kimg_per_tick"] == 1
    assert opts["network_snapshot_ticks"] == 25 and opts["metrics"] == METRICS
    assert opts["loss_weights"]["r1_gamma"] == 0 and opts["loss_weights"]["pl_weight"] == 0
    assert opts["device"] == "cpu" and opts["resume"] is None  # the extra arguments came last
    for name in METRICS:  # at the stop's snapshot tick (STAB_METRIC_TICKS 2: the first and last)
        (rec,) = _jsonl(os.path.join(stability["run1"], f"metric-{name}.jsonl"))
        assert rec["snapshot_path"] == stability["snap"]


def test_resume_starts_from_the_snapshot_and_continues_its_kimg(stability):
    s = stability
    assert s["rc2"] == 0, s["text2"][-3000:]
    with open(os.path.join(s["run2"], "training_options.json")) as f:
        opts = json.load(f)
    assert opts["resume"] == s["snap"] and opts["resume_kimg"] == 0
    # the state the first resumed step starts from holds the file's bits
    assert f"Resumed from {s['snap']} (restored state sha256 {s['digest']})" in s["text2"]
    (line,) = _jsonl(os.path.join(s["run2"], "stats.jsonl"))
    assert line["kimg"] == 0.016
    # the plain versions run on the CPU: no kernel launches
    assert {k: v for k, v in line.items() if k.startswith("launches/")} == {
        "launches/fused_attention": 0, "launches/fused_attention_dropout": 0,
        "launches/bias_act": 0, "launches/bias_act_backward": 0}


@pytest.mark.parametrize("name", DRY_RUN_NAMES, ids=["25", "8"])
def test_resume_kimg_comes_from_the_snapshot_name(started, name):
    """JAX's launcher strips the name's prefix only: a port ``.pt`` name
    would hand the trainer ``--resume-kimg 25.pt``. 000008 is not octal."""
    rc, text = _result(started, name)
    assert rc == 0, text[-3000:]
    kimg = int(name[len("network-snapshot-"):-len(".pt")])
    assert f'"resume_kimg": {kimg},' in text and "Dry run; exiting." in text


def test_resume_refuses_a_name_without_its_kimg(tmp_path):
    proc = subprocess.run(["bash", os.path.join(TOOLS, "run_stability_torch.sh"), *SMALL],
                          cwd=REPO_ROOT, env=_env(tmp_path, STAB_OUTDIR=str(tmp_path),
                                                  STAB_RESUME=str(tmp_path / "last.pt")),
                          capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 2 and "is not a network-snapshot-NNNNNN.pt" in proc.stderr


def test_launcher_trains_on_the_card_by_default(started):
    """Without --device cpu the trainer asks for the card: on a host
    without one it refuses, on a host with one its options name it."""
    rc, text = _result(started, "card")
    if torch.cuda.is_available():
        assert rc == 0 and '"device": "cuda"' in text
    else:
        assert rc == 2 and "--device cuda, but torch sees no CUDA device" in text


@pytest.mark.parametrize("piece", ["run1", "run2"])
def test_stability_report_counts_no_non_finite_values(stability, piece):
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, "stability_report.py"),
                           stability[piece], "--markdown"], capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr
    assert "non-finite loss values: 0" in proc.stdout and "| loss | first |" in proc.stdout
    assert "metric layout_fid50k_val:" in proc.stdout


def test_long_run_summary_joins_the_pieces(stability):
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, "long_run_summary_torch.py"),
                           stability["run1"], stability["run2"]], capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr
    assert "kimg: 0.016 over 2 pieces; non-finite values: 0" in proc.stdout
    assert "layout_fid50k_val: 0:" in proc.stdout and "augment_p: min 0.0" in proc.stdout


def test_stop_tool_without_a_run(tmp_path):
    proc = subprocess.run(["bash", os.path.join(TOOLS, "stop_stability_torch.sh")],
                          env=dict(os.environ, STAB_PIDFILE=str(tmp_path / "none.pid")),
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0 and "nothing to stop" in proc.stdout


def test_rehearsal_writes_its_summary(started):
    rc, text = _result(started, "rehearsal")
    out = started["root"] / "out"
    with open(out / "rehearsal_summary.txt") as f:
        summary = f.read()
    assert rc == 0, text[-3000:] + summary
    assert "Wrote 2 train / 1 val samples" in summary and "done: 3 pages" in summary
    assert "Maximum resident set size" in summary and "fastdata:" in summary
    assert "Background decode: native fastdata" in summary
    assert "post-compile median" in summary and "s/kimg" in summary
    (line,) = _jsonl(out / "rehearsal_stats.jsonl")
    assert line["sec_per_kimg"] > 0


def test_one_stop_sent_twice_at_once_is_one_request(monkeypatch, capsys):
    """GNU timeout passes a stop to its child and then to its process group:
    two SIGTERMs at once finish the tick; one sent a second later kills."""
    from layoutdetr_tpu_torch import train as port_train

    now = [100.0]
    sent, handlers = [], []
    monkeypatch.setattr(port_train.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(port_train.os, "kill", lambda pid, sig: sent.append(sig))
    monkeypatch.setattr(port_train.signal, "signal", lambda sig, h: handlers.append(h))
    term = port_train.StopRequest()
    assert not term.requested
    term(port_train.signal.SIGTERM, None)
    now[0] += 0.001
    term(port_train.signal.SIGTERM, None)
    assert term.requested and sent == [] and handlers == []
    assert capsys.readouterr().out.count("SIGTERM: finishing tick") == 1
    now[0] += port_train.TERM_REPEAT_S
    term(port_train.signal.SIGTERM, None)
    assert sent == [port_train.signal.SIGTERM] and handlers == [port_train.signal.SIG_DFL]
