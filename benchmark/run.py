"""Run one cell of the benchmark of the PyTorch port ``layoutdetr_tpu_torch``
once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name (``BENCHMARK.json``, ``benchmark/workloads/``,
``benchmark/configs/``, ``benchmark/traffic/mixes/``); its driver
(``benchmark/drivers/<driver>.py``) sets up, warms up, measures for
``--seconds`` and checks the timed path's output against the plain
reference (``benchmark/reference/``). With ``--trace 0`` the line holds the
cell's end-to-end metrics; with ``--trace 1`` a profiled stretch follows
the window and the line holds the cell's per-layer metrics, each read by
``benchmark/metrics/<metric>.py``, with the device's busy time and a
breakdown.

The line's keys: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``platform``, ``kind``, ``count``, ``memory_peak_bytes``; traced:
``busy_s``, ``window_s``), traced ``breakdown``, and last ``checks``: each
number compared for ``correct`` with its limit, also printed as the last
lines of standard error.

The run exits non-zero and prints no result without the cards the cell
asks for, or if JAX, flax or the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.harness import common  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="traffic, weights and randomness")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics from a profiled stretch")
    return ap.parse_args(argv)


def execute(args: argparse.Namespace, device=None, overrides=None, t_start: float = T_START,
            root: str = ROOT) -> dict:
    """One run; returns the result line. ``device`` None asks for the cards the
    cell needs; the harness's own tests pass "cpu" and ``overrides`` (dicts
    merged into the configuration's ``generator`` and the mix) to drive the
    rest of a run at a tiny size, and may point ``root`` at another
    checkout's files."""
    bench = common.bench_spec(root)
    files = common.cell_files(bench, args.workload, root)
    cell, spec = files["cell"], files["spec"]
    cfg, mix = dict(files["config_file"]), dict(files["mix"])
    if overrides:
        cfg["generator"] = {**cfg["generator"], **overrides.get("generator", {})}
        mix.update(overrides.get("mix", {}))
    common.prepare_environment(root)
    import torch

    common.stamp(t_start, "torch imported")
    if device is None:
        common.require_cards(cell["chips"])
        device = torch.device("cuda", 0)
        common.log(f"card: {common.card_line(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    common.set_precision(cfg)
    from layoutdetr_tpu_torch.ops import _build

    _build.BUILD_DIR = os.path.join(root, "build", "kernels")
    driver = common.load_module(os.path.join(root, "benchmark", "drivers", f"{spec['driver']}.py"),
                                f"benchmark_driver_{spec['driver']}")
    ctx = types.SimpleNamespace(workload=args.workload, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), chips=cell["chips"], spec=spec, cfg=cfg,
                                mix=mix, device=torch.device(device), t_start=t_start)
    common.stamp(t_start, "driver imported")
    out = driver.run(ctx)
    device_info = dict(platform="gpu" if ctx.device.type == "cuda" else ctx.device.type,
                       kind=out.device_kind, count=out.chips,
                       memory_peak_bytes=out.memory_peak_bytes)
    line = dict(correct=all(c.ok for c in out.checks) and out.failed == 0,
                attempted=out.attempted, failed=out.failed)
    if args.trace:
        metrics = {}
        for m in common.cell_per_layer(bench, args.workload):
            reader = common.load_module(os.path.join(root, "benchmark", "metrics", f"{m['name']}.py"),
                                        f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(out.probe)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        summary = out.probe["summary"]
        busy_s, window_s = out.probe["busy"]
        device_info.update(busy_s=busy_s, window_s=window_s)
        line.update(metrics=metrics, device=device_info,
                    breakdown=dict(device_ops=summary.top_ops(10), idle_gaps=summary.idle_gaps(10)))
    else:
        line.update(metrics={m["name"]: dict(value=out.e2e[m["name"]], unit=m["unit"])
                             for m in common.cell_e2e(bench, args.workload)},
                    device=device_info)
    line["checks"] = {c.name: dict(value=c.value, limit=c.limit) for c in out.checks}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        line = execute(args)
        loaded = common.forbidden_loaded()
        if loaded:
            raise common.RunError(f"modules loaded in the run that may not be: {loaded}")
    except common.RunError as e:
        print(f"[bench] no result: {e}", file=sys.stderr, flush=True)
        return 3
    for name, c in line["checks"].items():
        print(f"[bench] check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
