"""Nothing the benchmark runs loads JAX, flax or the JAX package
(compared by whole top-level module names), and the reference imports
nothing of the port."""

import ast
import os
import subprocess
import sys
import types

from tiny import ROOT, run_module

FORBIDDEN = {"jax", "jaxlib", "flax", "layoutdetr_tpu"}
BENCH = os.path.join(ROOT, "benchmark")


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(*parts):
    for d, _, files in os.walk(os.path.join(BENCH, *parts)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_forbidden_imports_in_sources():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(imported(path)) & FORBIDDEN, path


def test_yardstick_imports_nothing_of_the_port():
    for part in ("reference", "traffic", "rooflines"):
        for path in sources(part):
            assert "layoutdetr_tpu_torch" not in set(imported(path)), path


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, {tests!r}); import tiny; tiny.run_cell({cell!r}); "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {bad!r}))")
    for cell in ("r50.train.fp32", "r50.generate.fp32"):
        out = subprocess.run([sys.executable, "-c", code.format(tests=os.path.join(BENCH, "tests"),
                                                               cell=cell, bad=FORBIDDEN)],
                             capture_output=True, text=True, timeout=600, cwd=ROOT,
                             env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_refuses_a_run_with_jax_loaded(monkeypatch, capsys):
    run = run_module()
    monkeypatch.setattr(run, "execute", lambda args: dict(correct=True, checks={}))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "r50.train.fp32", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
