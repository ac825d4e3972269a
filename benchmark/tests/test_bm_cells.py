"""Each cell runs end to end on the CPU at a tiny size and gives the
benchmark's result line; without a card a run exits non-zero and prints no
result."""

import json

import pytest

from tiny import ROOT, run_cell, run_module

CELLS = [w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_gives_a_result_line(cell, trace):
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    line = run_cell(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == 1 and line["device"]["platform"] == "cpu"
    json.dumps(line)  # serializable
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run reads no device metric
        assert line["metrics"] == {}
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    rc = run_module().main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "torch.cuda.is_available() is false" in out.err
