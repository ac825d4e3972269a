"""Files, environment, device and output of one benchmark run.

A run finds everything by name: the cell in ``BENCHMARK.json``, its file
``benchmark/workloads/<cell>.json`` (driver and correctness limits),
the configuration file that ``BENCHMARK.json`` names, the traffic mix
``benchmark/traffic/mixes/<traffic>.json``, the cell's driver
``benchmark/drivers/<driver>.py`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Modules that may not be loaded in a run, compared by whole top-level name.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "layoutdetr_tpu")
# The H100 SXM's published dense peaks (NVIDIA data sheet, 700 W).
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


class RunError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


@dataclasses.dataclass
class Check:
    """One number compared for ``correct``, with its limit (<=)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    chips: int
    device_kind: str
    # read by the per-layer metrics of a traced run
    probe: Optional[Dict[str, Any]] = None


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: str, name: str):
    """Import the Python file ``path`` as module ``name``."""
    if not os.path.isfile(path):
        raise RunError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def cell_files(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The cell's entry, its own file, its configuration entry and file and
    its traffic mix, by name."""
    cell = find(bench["workloads"], workload, "workload")
    config = find(bench["configs"], cell["config"], "configuration")
    bench_dir = os.path.join(root, "benchmark")
    return dict(cell=cell, spec=load_json(os.path.join(bench_dir, "workloads", f"{workload}.json")),
                config=config, config_file=load_json(os.path.join(root, config["file"])),
                mix=load_json(os.path.join(bench_dir, "traffic", "mixes", f"{cell['traffic']}.json")))


def cell_e2e(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def cell_per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics reported in ``cell``: those that list it, and
    those without a ``workloads`` key whose end-to-end metric it reports."""
    names = {m["name"] for m in cell_e2e(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def prepare_environment(root: str = ROOT) -> None:
    """Fix every build and kernel cache inside the checkout and keep JAX out
    of libraries that would load it. Runs before torch is imported."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    # one host thread pool of few threads: the host dispatches, it does not compute
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the traffic is tokenized by the hash backend on both sides
    os.environ.pop("LAYOUTDETR_BERT_VOCAB", None)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def require_cards(chips: int):
    """The card count a cell needs, or RunError."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: this benchmark runs on CUDA cards only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


def set_precision(config_file: dict) -> None:
    """The configuration's float32 without TF32."""
    import torch

    tf32 = bool(config_file.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def card_line(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={index}"], capture_output=True,
                              text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"power limit unread ({type(e).__name__})"


def card_state(index: int = 0) -> str:
    """The card's SM clock, power draw and temperature, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                               "--format=csv,noheader", f"--id={index}"], capture_output=True,
                              text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def stamp(t_start: float, what: str) -> None:
    """Log ``what`` with the seconds since the process started."""
    import time

    log(f"{what} at {time.perf_counter() - t_start:.2f} s")


class Card:
    """The device a run uses: synchronization and the memory peak on a
    card; on the CPU (the harness's own tests) both are no-ops."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            self.torch.cuda.empty_cache()

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
