"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card: the program over many seeds, the control (the reference
computed in TF32 in the program's place, on its first seeds) and the
faults a cell can have, all in one process.

    python3 benchmark/calibrate.py --workload r50.train.fp32 --seeds 12 \\
        --first-seed 2147483700 --control 3 --faults 3 --out calib.json

Training cells read, per seed, the checked steps' ``loss_gap``,
``grad_gap`` and ``change_gap`` of the program against the reference; the
control's against the same reference; and the fault "half of the batch
left out" (each checked step of the program fed the first half of its
rows). A state left unchanged reads 1 on ``change_gap`` and needs no run.
Serving cells read ``box_gap`` over the requests a run checks, of the first
``WARMUP_REQUESTS`` + ``CHECKED_REQUESTS`` served; the control's over the
same requests. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.harness import common  # noqa: E402


def train_readings(ctx, driver, seeds, control, faults) -> dict:
    import torch

    from benchmark.harness import compare
    from benchmark.traffic import pages

    cfg, mix = ctx.cfg["generator"], ctx.mix
    batch, n = int(mix["batch"]), driver.CHECKED_STEPS
    out = dict(program=[], control=[], half_batch=[])
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        drawn = pages.draw_pages(mix, seed, cfg["background_size"], ctx.device)

        def pool():
            return pages.DevicePool(drawn, mix, seed, cfg["max_text_length"],
                                    cfg["max_text_length"], ctx.device)

        def program(corrupt=None):
            state, step = driver.build_program(cfg, seed, ctx.device, batch, t0)
            got = driver.program_checked(state, step, pool(), seed, n, corrupt=corrupt)
            del state, step
            torch.cuda.empty_cache()
            return got

        readings = dict(program=program())
        rows = readings["program"]["rows"]
        if i < control:
            ctl = driver.reference_checked(cfg, seed, ctx.device, pool(), rows, batch, tf32=True,
                                           keep_deltas=True)
            readings["control"] = dict(ctl, names_G=readings["program"]["names_G"],
                                       names_D=readings["program"]["names_D"])
        if i < faults:
            readings["half_batch"] = program(
                corrupt=lambda b: {k: v[: v.shape[0] // 2] for k, v in b.items()})
        reference = driver.reference_checked(cfg, seed, ctx.device, pool(), rows, batch,
                                             programs=list(readings.values()))
        for kind, got in readings.items():
            gaps = compare.train_gaps(got, reference)
            out[kind].append(dict(seed=seed, **{k: v[0] for k, v in gaps.items()},
                                  where={k: v[1] for k, v in gaps.items()}))
        common.log(f"seed {seed}: {out['program'][-1]} ({time.perf_counter() - t0:.1f} s)")
    return out


def serve_readings(ctx, driver, seeds, control) -> dict:
    import torch

    from benchmark.traffic import pages

    cfg, mix = ctx.cfg["generator"], ctx.mix
    n_results = int(mix["num_results"])
    out = dict(program=[], control=[])
    for i, seed in enumerate(seeds):
        requests = driver.make_requests(mix, seed, cfg["background_size"], ctx.device)
        model = driver.build_program(cfg, seed, ctx.device)
        arrivals = pages.Arrivals(mix, seed)
        served = [(arrivals.page(k), *driver.serve(model, requests[arrivals.page(k)], n_results,
                                                   ctx.device)[:2])
                  for k in range(driver.WARMUP_REQUESTS + driver.CHECKED_REQUESTS)]
        served = served[driver.WARMUP_REQUESTS:]
        del model
        torch.cuda.empty_cache()
        pick = driver.checked_sample(served, seed)
        picked, raws, masks = ([served[j][c] for j in pick] for c in range(3))
        want = driver.reference_outputs(cfg, seed, ctx.device, requests, picked, n_results)
        out["program"].append(dict(seed=seed, box_gap=driver.box_gap(raws, want, masks)))
        if i < control:
            ctl = driver.reference_outputs(cfg, seed, ctx.device, requests, picked, n_results,
                                           tf32=True)
            out["control"].append(dict(seed=seed, box_gap=driver.box_gap(ctl, want, masks)))
        common.log(f"seed {seed}: {out['program'][-1]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds the control runs on")
    ap.add_argument("--faults", type=int, default=3, help="seeds each fault runs on")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = common.bench_spec()
    files = common.cell_files(bench, args.workload)
    common.prepare_environment()
    import types

    import torch

    common.require_cards(files["cell"]["chips"])
    common.set_precision(files["config_file"])
    common.log(f"card: {common.card_line(0)}")
    spec = files["spec"]
    driver = common.load_module(os.path.join(ROOT, "benchmark", "drivers", f"{spec['driver']}.py"),
                                f"benchmark_driver_{spec['driver']}")
    ctx = types.SimpleNamespace(cfg=files["config_file"], mix=files["mix"], spec=spec,
                                device=torch.device("cuda", 0))
    seeds = [args.first_seed + i for i in range(args.seeds)]
    if spec["driver"] == "train_step":
        out = train_readings(ctx, driver, seeds, args.control, args.faults)
    else:
        out = serve_readings(ctx, driver, seeds, args.control)
    out.update(workload=args.workload, card=common.card_line(0))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for kind in ("program", "control", "half_batch"):
        rows = out.get(kind) or []
        for key in ("loss_gap", "grad_gap", "change_gap", "box_gap"):
            vals = [r[key] for r in rows if key in r]
            if vals:
                print(f"{kind} {key}: min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
