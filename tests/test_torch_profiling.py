"""The port's tracing helpers (``layoutdetr_tpu_torch.utils.profiling``):
``trace``, a Chrome trace of the enclosed block that holds its ranges, as
the bench's ``--profile`` writes it; and ``span``, a range only while a
profiler records, stamped on the wall clock, under a name the benchmark's
trace reader takes for a range."""

import json
import os
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import trace as bench_trace
from layoutdetr_tpu_torch.utils import profiling
from layoutdetr_tpu_torch.utils.profiling import span, trace

from test_torch_common import PORT_DIR, profiled_ranges
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def matmul_twice(x):
    with span("test.matmul_twice"):
        return x @ x @ x


def test_trace_writes_a_chrome_trace_with_the_range(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        matmul_twice(torch.randn(32, 32))
    names = {e.key for e in prof.key_averages()}
    assert "test.matmul_twice" in names and "aten::matmul" in names
    (path,) = os.listdir(log_dir)
    with open(log_dir / path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test.matmul_twice" for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        matmul_twice(torch.ones(4, 4))
    assert prof is None and not (tmp_path / "off").exists()


def test_span_opens_a_range_only_while_a_profiler_records(monkeypatch):
    calls = []
    real = profiling.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    assert not torch._C._autograd._profiler_enabled()
    for _ in range(3):
        matmul_twice(torch.ones(4, 4))
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        matmul_twice(torch.ones(4, 4))
    assert calls == ["test.matmul_twice"]


def test_spans_are_ranges_of_the_profile():
    def nested():
        with span("test.outer"):
            with span("test.inner"):
                torch.ones(8).sum()
            with span("test.inner"):
                torch.ones(8).sum()

    _, ranges = profiled_ranges(nested, "test.")
    assert [r[0] for r in ranges] == ["test.outer", "test.inner", "test.inner"]
    (_, s0, e0), *inner = ranges
    assert all(s0 <= s and e <= e0 for _, s, e in inner)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nested()
    events = list(prof.profiler.kineto_results.events())
    hosts = bench_trace._host_names(events)
    kinds = {bench_trace._kind(ev, hosts) for ev in events if ev.name().startswith("test.")}
    assert kinds == {"user_annotation"}


def test_span_is_stamped_on_the_wall_clock():
    marks = []

    def timed():
        marks.append(time.time_ns())
        with span("test.sleep"):
            time.sleep(0.02)
        marks.append(time.time_ns())

    _, [(_, start, end)] = profiled_ranges(timed, "test.sleep")
    slack = 1_000_000  # 1 ms
    assert marks[0] - slack <= start and end <= marks[1] + slack
    assert end - start >= 20_000_000 - slack


def test_every_span_name_in_the_port_is_a_range_name():
    names = set()
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r"\bspan\(\"([^\"]*)\"\)", fh.read()))
    assert {"train_step.Dmain", "train_step.backward", "generate.upload", "d_reg.r1"} <= names
    for name in names:
        assert bench_trace._RANGE.match(name) and "." in name, name
