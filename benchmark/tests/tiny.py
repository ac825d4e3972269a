"""A tiny configuration for the harness's own tests on the CPU, and a helper
that drives a whole run of a cell at it with the chip's look skipped."""

import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(hidden_dim=16, bert_f_dim=32, bert_num_heads=2, bert_num_encoder_layers=1,
            bert_num_decoder_layers=1, im_f_dim=16, max_text_length=16, nhead=2,
            num_encoder_layers=1, num_decoder_layers=1, reconst_decoder_layers=1,
            uncond_encoder_layers=1, dim_feedforward=32, background_size=32,
            backbone_stage_sizes=[1, 1, 1, 1], bert_intermediate_size=64,
            bert_max_position_embeddings=32)
OVERRIDES = dict(generator=TINY, mix=dict(pages=8, batch=2))
SEED = 2 ** 31 + 12345  # past 32 signed bits: a run takes seeds a little over 2**31


def run_module():
    spec = importlib.util.spec_from_file_location("benchmark_run", os.path.join(ROOT, "benchmark",
                                                                                "run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cell(workload: str, trace: int = 0, seed: int = SEED, root: str = ROOT,
             seconds: float = 0.5) -> dict:
    """The result line of one run of ``workload`` on the CPU at the tiny size."""
    import torch

    run = run_module()
    args = run.parse_args(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)])
    with torch.random.fork_rng():
        return run.execute(args, device="cpu", overrides=OVERRIDES, t_start=time.perf_counter(),
                           root=root)
