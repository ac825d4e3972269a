"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files, with entries in BENCHMARK.json, are found by name: no existing
file changes."""

import json
import os
import shutil

from tiny import ROOT, run_cell

READER = '''"""The steps of the window (a test's metric)."""


def read(probe):
    return float(probe["window_steps"])
'''


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(os.path.join(root, "benchmark")) for f in fs}
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b = os.path.join(root, "benchmark")

    config = json.load(open(os.path.join(b, "configs", "layoutdetr-r50.json")))
    config["name"] = "layoutdetr-r50-copy"
    json.dump(config, open(os.path.join(b, "configs", "layoutdetr-r50-copy.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "mixes", "banner_pool_b16.json")))
    json.dump(dict(mix, logo_p=0.0), open(os.path.join(b, "traffic", "mixes", "no_logo.json"), "w"))
    shutil.copy(os.path.join(b, "workloads", "r50.train.fp32.json"),
                os.path.join(b, "workloads", "copy.train.nologo.json"))
    open(os.path.join(b, "metrics", "window_steps.copy.py"), "w").write(READER)

    bench["configs"].append(dict(name="layoutdetr-r50-copy", source=config["source"],
                                 file="benchmark/configs/layoutdetr-r50-copy.json", reduced=[],
                                 why="a test's copy"))
    bench["workloads"].append(dict(name="copy.train.nologo", config="layoutdetr-r50-copy",
                                   traffic="no_logo", chips=1, why="a test's cell"))
    bench["per_layer"].append(dict(name="window_steps.copy", unit="steps", better="higher",
                                   source="program_counter", layer="train step driver",
                                   moves="train_images_per_s", workloads=["copy.train.nologo"]))
    for m in bench["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("copy.train.nologo")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    line = run_cell("copy.train.nologo", trace=1, root=root)
    assert line["correct"] is True
    assert line["metrics"]["window_steps.copy"]["value"] >= 1
    line = run_cell("copy.train.nologo", trace=0, root=root)
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    for path, data in before.items():
        assert open(path, "rb").read() == data, f"{path} changed"
