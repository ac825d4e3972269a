"""The port's tracing helper (``layoutdetr_tpu_torch.utils.profiling.trace``):
a Chrome trace of the enclosed block that holds its ``record_function``
ranges, as the bench's ``--profile`` writes it."""

import json
import os

import torch
from torch.profiler import record_function

from layoutdetr_tpu_torch.utils.profiling import trace

from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def matmul_twice(x):
    with record_function("matmul_twice"):
        return x @ x @ x


def test_trace_writes_a_chrome_trace_with_the_range(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        matmul_twice(torch.randn(32, 32))
    names = {e.key for e in prof.key_averages()}
    assert "matmul_twice" in names and "aten::matmul" in names
    (path,) = os.listdir(log_dir)
    with open(log_dir / path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_twice" for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        matmul_twice(torch.ones(4, 4))
    assert prof is None and not (tmp_path / "off").exists()
