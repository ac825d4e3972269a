"""The control on the card: the reference computed in TF32 in the program's
place fails the cell's limits, at the cell's own size, on one seed (the
limits were set from three or more). Needs a CUDA card; skips without one.

    python3 -m pytest benchmark/tests/test_bm_control.py -m cuda -q
"""

import types

import pytest

from tiny import ROOT, SEED

from benchmark import calibrate
from benchmark.harness import common


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r50.train.fp32", "r50.generate.fp32", "vitb16.train.fp32"])
def test_control_fails_a_limit(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which the CPU does not have")
    files = common.cell_files(common.bench_spec(), cell)
    common.set_precision(files["config_file"])
    spec = files["spec"]
    driver = common.load_module(f"{ROOT}/benchmark/drivers/{spec['driver']}.py",
                                f"bm_control_{spec['driver']}")
    ctx = types.SimpleNamespace(cfg=files["config_file"], mix=files["mix"], spec=spec,
                                device=torch.device("cuda", 0))
    if spec["driver"] == "train_step":
        out = calibrate.train_readings(ctx, driver, [SEED], control=1, faults=0)
    else:
        out = calibrate.serve_readings(ctx, driver, [SEED], control=1)
    (control,) = out["control"]
    assert any(control[k] > limit for k, limit in spec["limits"].items())
    (program,) = out["program"]
    assert all(program[k] <= limit for k, limit in spec["limits"].items())
