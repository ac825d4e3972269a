"""The port's dataset tool (``python -m layoutdetr_tpu_torch.dataset_tool``)
vs the root ``dataset_tool.py`` on one seeded production-shaped source
tree (``tools/make_production_source.py``, as ``tests/test_dataset_tool.py``
builds it): the zips hold the same entry names with the same bytes, with
and without ``--inpaint-aug`` / ``--max-samples`` / ``--png-compress``, and
the port's loader reads them."""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from layoutdetr_tpu_torch.data.dataset import LayoutDataset

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

sys.path.insert(0, str(Path(REPO_ROOT) / "tools"))


@pytest.fixture(scope="module")
def source_tree(tmp_path_factory):
    import make_production_source as mps

    out = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(0)
    dirs = {sub: out / sub for sub in ("png_json_gt", "1x_inpainted_background_png",
                                        "3x_inpainted_background_png")}
    for d in dirs.values():
        d.mkdir()
    for i in range(8):
        w, h = mps.FORMATS[int(rng.integers(0, len(mps.FORMATS)))]
        bg = mps._background(rng, w, h)
        elements = mps._layout(rng, w, h)
        page = mps._render(bg, elements, rng)
        name = f"page{i:06d}"
        PIL.Image.fromarray(page).save(dirs["png_json_gt"] / f"{name}.png", compress_level=1)
        (dirs["png_json_gt"] / f"{name}.json").write_text(json.dumps(elements))
        for sub, shift in (("1x_inpainted_background_png", 0), ("3x_inpainted_background_png", 17)):
            PIL.Image.fromarray((bg.astype(np.int32) + shift).clip(0, 255).astype(np.uint8)).save(
                dirs[sub] / f"{name}_inpainted.png", compress_level=1)
    return out


def _run(cmd, dest, flags):
    proc = subprocess.run([sys.executable, *cmd, "--dest", str(dest), *flags], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("flags", [[], ["--inpaint-aug", "--max-samples", "6", "--png-compress",
                                        "3"]], ids=["defaults", "inpaint-aug,max-samples"])
def test_zips_equal_the_root_tools(source_tree, tmp_path, flags):
    src = ["--source", str(source_tree)]
    want = _run([str(Path(REPO_ROOT) / "dataset_tool.py"), *src], tmp_path / "root", flags)
    got = _run(["-m", "layoutdetr_tpu_torch.dataset_tool", *src], tmp_path / "port", flags)
    assert got.replace(str(tmp_path / "port"), "") == want.replace(str(tmp_path / "root"), "")
    for name in ("train.zip", "val.zip"):
        with zipfile.ZipFile(tmp_path / "root" / name) as a, \
                zipfile.ZipFile(tmp_path / "port" / name) as b:
            assert a.namelist() == b.namelist(), name
            assert len(a.namelist()) > 1
            for entry in a.namelist():
                assert a.read(entry) == b.read(entry), f"{name}/{entry}"

    train = LayoutDataset(str(tmp_path / "port" / "train.zip"), background_size=64,
                          max_text_length=16, load_patches=True)
    item = train[0]
    n = int(item["mask"].sum())
    assert 1 <= n <= 9 and item["background"].shape == (64, 64, 3)
    assert item["patches_orig"].shape == (9, 1024, 1024, 3)
    assert np.abs(item["patches_orig"][:n]).sum() > 0


def test_png_compress_is_bounded(source_tree, tmp_path):
    proc = subprocess.run([sys.executable, "-m", "layoutdetr_tpu_torch.dataset_tool", "--source",
                           str(source_tree), "--dest", str(tmp_path), "--png-compress", "10"],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "not in 0-9" in proc.stderr
