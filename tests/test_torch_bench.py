"""The port's bench (``python -m layoutdetr_tpu_torch.bench``): the JAX
bench's one-JSON-line stdout contract (``tests/test_bench.py``) in a fresh
process, smoke config on the CPU, for the train step and ``--infer``; the
FLOP count taken on the plain attention path, so the kernel path and
``--no-flash`` count the same; the A/B knobs; no fallback to the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from layoutdetr_tpu_torch import bench

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_source", "value_sustained",
        "value_burst", "vs_baseline_burst")
QUICK = ["--smoke", "--device", "cpu", "--steps", "1", "--burst-steps", "1", "--warmup", "0"]


@pytest.mark.parametrize("infer", [False, True], ids=["train", "infer"])
def test_smoke_prints_one_json_line(infer):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "layoutdetr_tpu_torch.bench", "--smoke", "--device", "cpu"]
    out = subprocess.run(cmd + (["--infer"] if infer else []), cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-2000:])
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"stdout must be ONE JSON line, got: {lines}"
    rec = json.loads(lines[0])
    assert tuple(rec) == KEYS
    assert rec["metric"] == ("gan_inference_throughput" if infer else "gan_train_step_throughput")
    assert rec["unit"] == "imgs/sec/chip"
    assert rec["value"] == rec["value_sustained"] > 0 and rec["value_burst"] > 0
    assert rec["baseline_source"] in ("derived", "fallback")
    assert "[bench]" in out.stderr and "flops/img=" in out.stderr


@pytest.mark.parametrize("infer", [False, True], ids=["train", "infer"])
def test_flop_count_is_the_plain_paths(infer, capsys):
    """The count runs on plain attention: the kernel path's count is
    positive and equals --no-flash's (on the CPU both run the plain
    version, and the counter would see the kernel's there too)."""
    extra = ["--infer"] if infer else []
    got = bench.main(QUICK + extra)
    plain = bench.main(QUICK + extra + ["--no-flash"])
    assert got["flops_per_step"] > 0 and got["flops_source"] == "derived"
    assert got["flops_per_step"] == plain["flops_per_step"]
    assert got["line"]["baseline_source"] == "derived"
    assert got["calls"] == dict(flop_count=1, warmup=0, burst=1, sustained=1)
    assert "mfu" not in got  # no card: no device metric
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_no_share_text_encoder_counts_a_second_encoder_pass(capsys):
    shared = bench.main(QUICK)["flops_per_step"]
    separate = bench.main(QUICK + ["--no-share-text-encoder"])["flops_per_step"]
    assert separate > shared
    capsys.readouterr()


def test_flash_switch_is_restored_after_the_count():
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.generator import Generator

    G = Generator(GeneratorConfig(**bench.SMOKE))

    def switches():
        return [m.flash_attention for m in bench.attention_layers((G,))]

    before = switches()
    assert True in before and False in before  # the encoder's on, the causal decoder's off
    inside = []
    assert bench.count_flops(lambda: inside.append(switches()), (G,)) is None  # nothing multiplied
    assert inside == [[False] * len(before)] and switches() == before


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--smoke"])
