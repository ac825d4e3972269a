"""The training run on the CPU: the port's ``training_loop`` at tiny dims
(3 steps with ADA, R1 and path-length steps, a snapshot each tick),
resume, abort, and the ``train`` CLI's options against the JAX package's
click command."""

import json
import os

import numpy as np
import pytest
import torch

from layoutdetr_tpu_torch import train as port_train
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.training import train_loop
from layoutdetr_tpu_torch.training.loss import LossWeights
from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot, snapshot_of

from test_torch_checkpoint import _assert_same
from test_torch_common import TINY_KW
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

# the tokenizer emits real BERT-range ids: the full vocab at width 32
CFG = GeneratorConfig(**{**TINY_KW, "vocab_size": 30524, "bos_token_id": 30522,
                         "reconst_decoder_layers": 1, "uncond_encoder_layers": 1})
WEIGHTS = LossWeights(pl_weight=2.0, r1_gamma=1.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    return make_synthetic_zip(str(d / "train.zip"), num_samples=8, image_size=32, max_elements=9,
                              seed=0, structured=True)


def _run(run_dir, data, **kw):
    os.makedirs(run_dir, exist_ok=True)
    args = dict(run_dir=run_dir, data=data, gcfg=CFG, loss_weights=WEIGHTS, batch_size=2,
                kimg_per_tick=1, network_snapshot_ticks=1, image_snapshot_ticks=1, aug="ada",
                device="cpu", module_summary=False)
    args.update(kw)
    return train_loop.training_loop(**args)


def _jsonl(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def first_run(data, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("run"))
    state = _run(run_dir, data, max_steps=3, device_feed="on", module_summary=True)
    return run_dir, state


def test_three_steps_with_ada_and_both_regularizers(first_run):
    run_dir, state = first_run
    assert state.step == 3 and float(state.pl_mean) > 0
    lines = _jsonl(run_dir)
    assert len(lines) == 2  # tick 0 after the first step, then the last tick
    steps_in_tick = (1, 2)
    for line, steps in zip(lines, steps_in_tick):
        for k, v in line.items():  # a stat no step of the tick reported has num 0
            if isinstance(v, dict) and v["num"]:
                assert np.isfinite(v["mean"]) and np.isfinite(v["std"]), k
        # the collector drops non-finite values: every step's stat arrived
        assert line["Loss/D/loss_Dreal"]["num"] == line["Loss/G/loss_Ggen"]["num"] == steps
    seen = set().union(*lines)
    for k in ("Loss/G/reg", "Loss/D/reg", "Loss/pl_penalty", "Loss/r1_penalty", "Loss/signs/real",
              "augment_p", "ada_updates", "main_step_s", "reg_step_s", "sec_per_kimg"):
        assert k in seen, k
    # the reg steps run at batch 0 only (intervals 4 and 16): in the first tick
    assert lines[0]["Loss/G/reg"]["num"] == 1 and lines[0]["Loss/D/reg"]["num"] == 1
    assert lines[-1]["Loss/G/reg"]["num"] == lines[-1]["Loss/D/reg"]["num"] == 0
    assert lines[0]["reg_step_s"] > 0 and lines[-1]["reg_step_s"] == 0
    names = os.listdir(run_dir)
    assert "network-snapshot-000000.pt" in names and "network-snapshot-000000.pt.gcfg.json" in names
    assert "fakes000000_0.png" in names
    with open(os.path.join(run_dir, "network-snapshot-000000.pt.gcfg.json")) as f:
        assert GeneratorConfig.from_dict(json.load(f)) == CFG
    # the final snapshot is the final state
    _assert_same(load_snapshot(os.path.join(run_dir, "network-snapshot-000000.pt")),
                 snapshot_of(state), "snapshot")


def test_resume_loads_the_snapshot_bit_exact(first_run, data, tmp_path, monkeypatch):
    """The state restored before the first resumed step equals the snapshot
    bit for bit (checked inside the loop's restore); then a step runs."""
    run_dir, _ = first_run
    snap = os.path.join(run_dir, "network-snapshot-000000.pt")
    restored = []
    real = train_loop.restore_checkpoint

    def check(path, state):
        out = real(path, state)
        _assert_same(snapshot_of(state), load_snapshot(path), "restored")
        restored.append(state.step)
        return out

    monkeypatch.setattr(train_loop, "restore_checkpoint", check)
    state = _run(str(tmp_path), data, resume=snap, max_steps=1, device_feed="off", num_workers=0)
    assert restored == [3] and state.step == 4
    assert len(_jsonl(str(tmp_path))) == 1


def test_init_g_and_init_d_graft_a_snapshot(first_run, data, tmp_path):
    """--init-g/--init-d load a snapshot's G and D onto the fresh init: the
    frozen parameters, which the step leaves alone, are the snapshot's."""
    run_dir, _ = first_run
    snap_path = os.path.join(run_dir, "network-snapshot-000000.pt")
    snap = load_snapshot(snap_path)
    state = _run(str(tmp_path), data, init_g=snap_path, init_d=snap_path, max_steps=1,
                 device_feed="on", random_seed=5)
    for key, module in (("G", state.G), ("D", state.D)):
        frozen = [n for n, p in module.named_parameters() if not p.requires_grad]
        assert frozen
        sd = module.state_dict()
        assert all(torch.equal(sd[n], snap[key][n]) for n in frozen), key


def test_abort_fn_snapshots_and_stops(data, tmp_path):
    ticks = []
    state = _run(str(tmp_path), data, max_steps=50, device_feed="off", num_workers=0,
                 abort_fn=lambda: True, progress_fn=lambda kimg, total: ticks.append(kimg),
                 loss_weights=LossWeights())
    assert state.step == 1 and ticks == [0]
    assert os.path.exists(tmp_path / "network-snapshot-000000.pt")
    assert "Loss/G/reg" not in _jsonl(str(tmp_path))[0]  # the regularizers are off


def test_cli_options_match_the_jax_cli():
    """Every option of the JAX package's click command, with its default
    (--metrics layout_fid50k_val included), but the port's --device."""
    import train as jax_train  # the JAX package's CLI at the repo root

    ap = port_train.build_parser()
    ours = {s: a.default for a in ap._actions for s in a.option_strings if s not in ("-h", "--help")}
    def default(p):  # click marks the default of a required option with a sentinel
        return None if type(p.default).__name__ == "Sentinel" else p.default

    theirs = {opt: default(p) for p in jax_train.main.params for opt in p.opts + p.secondary_opts}
    skip = {"--device"}
    assert set(ours) - skip == set(theirs) - skip
    for opt, default in theirs.items():
        if opt not in skip:
            assert ours[opt] == default, (opt, ours[opt], default)
    assert ours["--device"] == "cuda" and ours["--metrics"] == "layout_fid50k_val"


@pytest.mark.parametrize("argv, message", [
    (["--metrics", "fid50k"], "unknown metric fid50k"),
    (["--chips", "2"], "item 19"),
    (["--gpus", "4"], "item 19"),
    (["--model-parallel", "2"], "item 19"),
    (["--backbone", "vit"], "item 19"),
    (["--load-patches"], "not ported"),
    (["--max-text-length", "0"], "positive integer"),
])
def test_cli_refuses_what_waits(argv, message, data, tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_train.main(["--outdir", str(tmp_path), "--data", data, "--batch", "2", "--device", "cpu",
                         *argv])
    assert message in capsys.readouterr().err


def test_cli_dry_run_resolves_auto_text_length(data, tmp_path, capsys):
    assert port_train.main(["--outdir", str(tmp_path), "--data", data, "--batch", "2", "--device",
                            "cpu", "--max-text-length", "auto", "--metrics", "none",
                            "--dry-run"]) is None
    out = capsys.readouterr().out
    assert "-> T=16" in out and "Dry run" in out and not os.listdir(tmp_path)


def test_nan_guard_and_collector():
    from layoutdetr_tpu.utils.stats import Collector as JaxCollector
    from layoutdetr_tpu_torch.utils.misc import nan_guard
    from layoutdetr_tpu_torch.utils.stats import Collector

    nan_guard({"ok": torch.ones(3)})
    with pytest.raises(FloatingPointError, match="at step 3: bad"):
        nan_guard({"bad": torch.tensor([1.0, float("nan")])}, "step 3: ")
    ours, ref = Collector(), JaxCollector()
    for c in (ours, ref):
        c.report_dict({"a": 1.0, "b": [2.0, float("inf"), 4.0]})
        c.update()
        c.report("a", 3.0)
        c.update()
    got, want = ours.as_dict(), ref.as_dict()
    assert got.keys() == want.keys() == {"a", "b"}
    for name in got:  # NaN for a stat nobody reported since the last update
        np.testing.assert_equal(got[name], want[name])
    assert got["a"] == {"num": 1, "mean": 3.0, "std": 0.0} and got["b"]["num"] == 0
