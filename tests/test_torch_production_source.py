"""The port's source generator (``python -m layoutdetr_tpu_torch.production_source``)
against JAX's ``tools/make_production_source.py``, run as it is in a
subprocess: for the same seed the two trees hold the same files, equal
JSON and equal PNG pixels, whatever the port's worker count; then the
port's dataset tool keeps every page of such a tree at ``--png-compress 3``."""

import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from layoutdetr_tpu_torch import dataset_tool, production_source
from layoutdetr_tpu_torch.data.dataset import LayoutDataset

from test_torch_common import REPO_ROOT
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

PAGES = 4


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _jax_tree(out, seed):
    proc = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools",
                                                        "make_production_source.py"),
                           "--out", str(out), "--pages", str(PAGES), "--seed", str(seed)],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("seed,workers", [(0, 1), (3, 3)], ids=["seed0-workers1", "seed3-workers3"])
def test_tree_equals_the_jax_tools(tmp_path, seed, workers):
    _jax_tree(tmp_path / "jax", seed)
    proc = subprocess.run([sys.executable, "-m", "layoutdetr_tpu_torch.production_source",
                           "--out", str(tmp_path / "port"), "--pages", str(PAGES), "--seed",
                           str(seed), "--workers", str(workers)],
                          cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=REPO_ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"done: {PAGES} pages" in proc.stdout
    names = _tree(tmp_path / "jax")
    assert names == _tree(tmp_path / "port") and len(names) == 3 * PAGES
    for name in names:
        want, got = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text()), name
        else:
            a, b = np.asarray(PIL.Image.open(got)), np.asarray(PIL.Image.open(want))
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_page_draws_follow_the_jax_tools_stream():
    """The draws made ahead of the pixels leave the stream where JAX's
    interleaved calls leave it."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    try:
        import make_production_source as mps
    finally:
        sys.path.pop(0)
    rng_jax, rng_port = np.random.default_rng(7), np.random.default_rng(7)
    for i, w, h, blobs, elements, lights in production_source.page_draws(rng_port, 6):
        w2, h2 = mps.FORMATS[int(rng_jax.integers(0, len(mps.FORMATS)))]
        bg = mps._background(rng_jax, w2, h2)
        assert (w, h) == (w2, h2) and mps._layout(rng_jax, w, h) == elements
        mps._render(bg, elements, rng_jax)
        assert np.array_equal(production_source._paint_background(w, h, blobs), bg), i
    assert rng_port.random() == rng_jax.random()


def test_dataset_tool_keeps_every_page(tmp_path):
    production_source.write_source(str(tmp_path / "src"), pages=PAGES, seed=0, workers=1)
    n_train, n_val = dataset_tool.main(["--source", str(tmp_path / "src"), "--dest",
                                        str(tmp_path / "zips"), "--png-compress", "3"])
    split = int(PAGES * 0.90)  # the tool's own: the first 90% of the kept pages
    assert (n_train, n_val) == (split, PAGES - split)
    for name, n in (("train.zip", n_train), ("val.zip", n_val)):
        ds = LayoutDataset(str(tmp_path / "zips" / name), background_size=32,
                           max_text_length=16, cache=False, use_native=False)
        assert len(ds) == n
        sample = ds.collate([0])
        assert sample["background"].shape[1:3] == (32, 32) and sample["mask"].any()
