"""The span readers (``benchmark/harness/spans.py``) on hand-built traces,
the seven metrics that read the port's spans, found by name, and the port's
spans as the harness's trace reduces them in a traced run at the tiny size."""

import json
import os

import pytest

from tiny import ROOT, run_cell

from benchmark.harness import common, spans, trace
from benchmark.harness.trace import DeviceOp, Summary

MS = 1_000_000  # ns


def kernel(start, end, device=0):
    return DeviceOp("k", "kernel", start * MS, end * MS, device)


def summary(ops, ranges, range_kernels=None, steps=1, t1=100):
    return Summary(steps=steps, window_s=t1 / 1e3, ops=ops,
                   ranges={n: [(s * MS, e * MS) for s, e in ivs] for n, ivs in ranges.items()},
                   range_kernels=range_kernels or {n: [] for n in ranges}, host_ops=[],
                   launches=len(ops), t0=0, t1=t1 * MS)


# the device-only stretch: idle 25 of 100 ms, half the hand-built stretch's
# 50 ms of idle on device 0, so every idle reading is half its share there
BUSY = (0.075, 0.1)


def probe(s, busy=BUSY):
    return dict(summary=s, busy=busy)


# busy on device 0 over [10, 20], [30, 40], [60, 90] (two kernels overlap in
# the last); device 1 busy throughout, which the readers leave out
K1, K2, K3, K4 = kernel(10, 20), kernel(30, 40), kernel(60, 80), kernel(70, 90)
OPS = [K1, K2, K3, K4, kernel(0, 100, device=1)]
RANGES = {"a.x": [(5, 25), (50, 95)],  # repeated; its second instance opens inside a gap
          "a.inner": [(52, 58)],  # nested inside a.x
          "b.y": [(22, 45)],  # overlaps a.x
          "c.quiet": [(91, 99)]}  # launches nothing
LAUNCHED = {"a.x": [K1, K3, K4, K3], "a.inner": [K3], "b.y": [K2], "c.quiet": []}


def test_idle_intervals_of_the_first_device():
    got = spans.idle_intervals(summary(OPS, RANGES))
    assert [(s // MS, e // MS) for s, e in got] == [(0, 10), (20, 30), (40, 60), (90, 100)]


@pytest.mark.parametrize("names, want", [
    (["a.x"], 5 + 5 + 10 + 5),  # [5, 10], [20, 25], [50, 60], [90, 95]
    (["a.inner"], 6),
    (["a.x", "a.inner"], 25),  # the nested span adds nothing
    (["b.y"], 8 + 5),  # [22, 30], [40, 45]
    (["a.x", "b.y"], 5 + 10 + 5 + 10 + 5),  # the union: [5, 45], [50, 95]
    (["c.quiet"], 8),
])
def test_idle_ms_within_the_named_spans(names, want):
    """``want``: the span's idle in the profiled stretch, of its 50 ms."""
    full = summary(OPS, RANGES, LAUNCHED)
    assert spans.idle_ms(probe(full), names) == pytest.approx(want / 2, rel=1e-12)
    assert spans.idle_ms(probe(full, busy=(0.05, 0.1)), names) == pytest.approx(want, rel=1e-12)
    four = summary(OPS, RANGES, LAUNCHED, steps=4)
    assert spans.idle_ms(probe(four), names) == pytest.approx(want / 8, rel=1e-12)


def test_idle_ms_of_a_stretch_without_idle():
    full = summary([kernel(0, 100)], RANGES, LAUNCHED)
    assert spans.idle_ms(probe(full), ["a.x"]) == 0.0


@pytest.mark.parametrize("names, want", [
    (["a.x"], 3),  # K3 twice in the list (nested instances of one name): counted once
    (["a.x", "a.inner"], 3),
    (["a.x", "b.y"], 4),
    (["c.quiet"], 0),
])
def test_launches_of_the_named_spans(names, want):
    assert spans.launches(probe(summary(OPS, RANGES, LAUNCHED, steps=2)), names) == want / 2


@pytest.mark.parametrize("reader", [spans.idle_ms, spans.launches])
def test_nothing_to_read(reader):
    assert reader(probe(summary(OPS, RANGES, LAUNCHED)), ["a.x", "missing.span"]) is None
    assert reader(probe(summary([], RANGES)), ["a.x"]) is None  # no card
    assert reader(None, ["a.x"]) is None


# one request or step: busy over [20, 30] and [40, 70], idle 60 ms, as the
# device-only stretch the readers are given
PORT_OPS = [kernel(20, 30), kernel(40, 70)]
PORT_RANGES = {"generate.encode": [(0, 10)], "generate.upload": [(10, 30)],
               "generate.forward": [(30, 80)], "generate.download": [(80, 90)],
               "generate.postprocess": [(90, 100)],
               "train_step.forward": [(0, 30)], "train_step.backward": [(30, 100)],
               "train_step.G_adam": [(0, 5)], "train_step.D_adam": [(5, 8)],
               "train_step.ema": [(8, 9)]}
PORT_LAUNCHED = {n: [] for n in PORT_RANGES}
PORT_LAUNCHED.update({"train_step.forward": [PORT_OPS[0]], "train_step.G_adam": [PORT_OPS[1]],
                      "train_step.D_adam": [kernel(50, 51)], "train_step.ema": [kernel(60, 61)]})
OLDER_SPANS = ("train_step.G_adam", "train_step.D_adam", "train_step.ema")
METRICS = {
    "generate.host_idle_ms.generate": 10 + 10,
    "generate.upload_idle_ms.generate": 10,
    "generate.forward_idle_ms.generate": 10 + 10,
    "train_step.forward_idle_ms.train": 20,
    "train_step.backward_idle_ms.train": 10 + 30,
    "train_step.forward_launches.train": 1,
    "train_step.update_launches.train": 3,
}


def reader(name):
    return common.load_module(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"),
                              f"benchmark_metric_{name.replace('.', '_')}")


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metrics_are_found_by_name(name):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    for cell in entry["workloads"]:
        assert entry in common.cell_per_layer(bench, cell)
    read = reader(name).read
    port = summary(PORT_OPS, PORT_RANGES, PORT_LAUNCHED)
    assert read(probe(port, busy=(0.04, 0.1))) == pytest.approx(METRICS[name], rel=1e-12)
    # a program that marks only the step's phases reads the update's launches
    # alone, and raises nothing where it lacks a span
    older = {n: ivs for n, ivs in PORT_RANGES.items() if n in OLDER_SPANS}
    older_launched = {n: ks for n, ks in PORT_LAUNCHED.items() if n in OLDER_SPANS}
    got = read(probe(summary(PORT_OPS, older, older_launched)))
    assert got == (METRICS[name] if name == "train_step.update_launches.train" else None)


GENERATE_SPANS = ["generate.encode", "generate.upload", "generate.forward", "generate.download",
                  "generate.postprocess"]
TRAIN_SPANS = ["train_step.text", "train_step.Gmain", "train_step.G_adam", "train_step.Dmain",
               "train_step.D_adam", "train_step.ema", "train_step.forward", "train_step.backward",
               "train_step.sanitize"]


@pytest.mark.parametrize("cell, per_step", [
    ("r50.generate.fp32", dict.fromkeys(GENERATE_SPANS, 1)),
    ("r50.train.fp32", {**dict.fromkeys(TRAIN_SPANS, 1), "train_step.forward": 2,
                        "train_step.backward": 2, "train_step.sanitize": 2}),
])
def test_port_spans_are_ranges_of_a_traced_cell(cell, per_step, monkeypatch):
    """A traced run at the tiny size: the harness's trace keeps each of the
    port's spans as a range, once a request or as often as a step opens it."""
    kept = []
    profile = trace.profile
    monkeypatch.setattr(trace, "profile", lambda *a: kept.append(profile(*a)) or kept[-1])
    run_cell(cell, trace=1)
    (stretch,) = kept
    for name, n in per_step.items():
        assert len(stretch.ranges[name]) == n * stretch.steps, name
