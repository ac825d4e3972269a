"""The port's host-side background decoder (``data/native.py`` over
``data/csrc/fastdata.cpp``) vs the JAX package's (``native/fastdata.cpp``)
and vs PIL.

Bars: the port's decode and normalise give JAX's bits, and its Lanczos
resize PIL's (it runs in PIL's fixed point); JAX's resize, which sums in
double and rounds, is at most 1 level off both. The port's
``LayoutDataset(use_native=True)`` background equals its PIL path's bit for
bit and JAX's native one within a level, with the sample cache on and off.

JAX's side is a private build of its own source with its own command
(``jax_native_private``), never the ``native/libfastdata.so`` that JAX's
loader compiles in place while other test processes load it.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
import PIL.Image
import pytest

from layoutdetr_tpu.data import native as jax_native
from layoutdetr_tpu.data.dataset import LayoutDataset as JaxDataset
from layoutdetr_tpu_torch.data import dataset as ds
from layoutdetr_tpu_torch.data import native
from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
from layoutdetr_tpu_torch.ops import _build

from test_torch_common import REPO_ROOT, jax_native_command
from test_torch_common import jax_native_private  # noqa: F401 (module-scoped fixture)
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

pytestmark = pytest.mark.usefixtures("jax_native_private")

CASES = [((21, 33, 3), "RGB"), ((90, 728, 3), "RGB"), ((16, 16), "L"), ((37, 29, 4), "RGBA"),
         ((12, 40, 2), "LA")]


def _png(arr, mode, level):
    buf = io.BytesIO()
    PIL.Image.fromarray(arr, mode).save(buf, format="png", compress_level=level)
    return buf.getvalue()


def _rgb(arr):
    """What the decoder returns for a PNG of ``arr``: gray repeated, alpha dropped."""
    if arr.ndim == 2:
        return np.stack([arr] * 3, -1)
    return np.repeat(arr[..., :1], 3, -1) if arr.shape[2] == 2 else arr[..., :3]


def test_library_builds_from_the_ports_source_into_build():
    path = native.library()._name
    assert native.available()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libfastdata-") and path.endswith(".so")
    assert not os.path.samefile(native.SRC, os.path.join(REPO_ROOT, "native", "fastdata.cpp"))


def test_jax_side_is_a_private_build_of_jax_source(jax_native_private):  # noqa: F811
    """The JAX decoder these tests load sits under ``build/kernels/``, was
    built from ``native/fastdata.cpp`` by JAX's own command, and is not
    ``native/libfastdata.so``."""
    path = jax_native_private
    assert jax_native._SO == path and jax_native._lib._name == path
    assert os.path.dirname(path) == _build.BUILD_DIR
    jax_src = os.path.join(REPO_ROOT, "native", "fastdata.cpp")
    assert os.path.samefile(jax_native._SRC, jax_src)
    so = os.path.join(REPO_ROOT, "native", "libfastdata.so")
    assert not os.path.exists(so) or not os.path.samefile(path, so)
    compiler, flags, libs = jax_native_command()
    assert (compiler, flags, libs) == ("g++", ("-O3", "-shared", "-fPIC"), ("-lz",))
    with open(path + ".log") as f:
        cmd = f.readline().split()
    out = cmd.index("-o")
    assert cmd[:out] == [compiler, *flags] and cmd[out + 2:] == [jax_native._SRC, *libs], cmd
    assert cmd[out + 1].startswith(path + "."), cmd  # the temporary file os.replace moved


_BUILD_AND_LOAD = """
import ctypes, sys, time
sys.path.insert(0, sys.argv[1])
from layoutdetr_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[2]
while time.time() < float(sys.argv[3]):
    pass
path = _build._compile(sys.argv[4], "g++", tuple(sys.argv[5:-1]), (sys.argv[-1],))
ctypes.CDLL(path).fd_decode_png
print(path)
"""


@pytest.mark.parametrize("which", ["jax", "port"])
def test_processes_building_at_once_all_load_the_library(which, tmp_path):
    """Six processes compile one source into one empty build directory at
    the same moment, as test workers do; each loads a whole library (the
    race JAX's in-place build loses: "file too short")."""
    src = jax_native._SRC if which == "jax" else native.SRC
    compiler, flags, libs = jax_native_command()
    start = time.time() + 1.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, REPO_ROOT, str(tmp_path),
                               str(start), src, *flags, *libs], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-300:] for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(outs[0][0].strip()) + e for e in ("", ".log")])


@pytest.mark.parametrize("level", [0, 6])
@pytest.mark.parametrize("shape,mode", CASES, ids=[m + "x".join(map(str, s)) for s, m in CASES])
def test_native_matches_jax_bit_for_bit_and_pil(shape, mode, level):
    rng = np.random.default_rng(len(shape) * 10 + level)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _png(arr, mode, level)
    dec = native.decode_png(data)
    np.testing.assert_array_equal(dec, jax_native.decode_png(data))
    np.testing.assert_array_equal(dec, _rgb(arr))  # PIL's pixels, exactly
    for size in (8, 24, 64):
        got = native.resize_lanczos(dec, size)
        pil = np.array(PIL.Image.fromarray(dec).resize((size, size), PIL.Image.LANCZOS))
        np.testing.assert_array_equal(got, pil)
        jax_got = jax_native.resize_lanczos(dec, size)
        assert np.abs(got.astype(int) - jax_got.astype(int)).max() <= 1
        bg = native.load_background(data, size)
        assert bg.dtype == np.float32 and bg.shape == (size, size, 3)
        assert np.array_equal(bg, ds.normalize_image(got))
        np.testing.assert_array_equal(ds.normalize_image(jax_got),
                                      jax_native.load_background(data, size))


@pytest.mark.parametrize("src,size", [((1024, 1024), 256), ((250, 300), 256), ((64, 48), 24)])
def test_lanczos_within_a_level_of_pil(src, size):
    """A banner background at the loader's sizes, and upscaling: the
    port's resize is PIL's exactly, dithered or smooth (where a resize
    that rounds double sums is a level off on up to a few percent of the
    pixels)."""
    rng = np.random.default_rng(1)
    h, w = src
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256], -1)
    img = np.clip(smooth + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    for case in (img, smooth.astype(np.uint8)):
        pil = np.array(PIL.Image.fromarray(case).resize((size, size), PIL.Image.LANCZOS))
        np.testing.assert_array_equal(native.resize_lanczos(case, size), pil)


def test_malformed_input_is_refused():
    with pytest.raises(ValueError, match="not a PNG"):
        native.decode_png(b"GIF89a" + bytes(40))
    data = bytearray(_png(np.zeros((4, 4, 3), np.uint8), "RGB", 0))
    data[16:20] = (1 << 20).to_bytes(4, "big")  # a width past the bound
    with pytest.raises(ValueError, match="out of range"):
        native.load_background(bytes(data), 8)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        native.resize_lanczos(np.zeros((4, 4), np.uint8), 2)


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    return make_synthetic_zip(str(tmp_path_factory.mktemp("native") / "train.zip"),
                              num_samples=6, image_size=96, max_elements=9, seed=2,
                              structured=True)


@pytest.mark.parametrize("cache", [True, False])
def test_dataset_native_background_equals_jax(zip_path, cache):
    kw = dict(background_size=32, max_text_length=16, cache=cache, use_native=True)
    port, ref = ds.LayoutDataset(zip_path, **kw), JaxDataset(zip_path, **kw)
    assert port.use_native and (port._cache is not None) == cache
    pil = ds.LayoutDataset(zip_path, **dict(kw, use_native=False))
    for i in range(len(port)):
        a, b = port[i]["background"], ref[i]["background"]
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, pil[i]["background"]), i
        assert np.abs(a - b).max() < 2.0 / (255 * 0.224), i  # <= 1 level, scaled by 1 / (255 std)


def test_broken_compiler(zip_path, tmp_path, monkeypatch, capsys):
    """use_native=True raises with the compiler's failure; auto falls back to
    PIL and says why; False never builds."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(ds, "_decoder_told", False)
    with pytest.raises(RuntimeError, match="fastdata did not build: false failed"):
        ds.LayoutDataset(zip_path, background_size=32, max_text_length=16, use_native=True)
    assert not native.available()
    auto = ds.LayoutDataset(zip_path, background_size=32, max_text_length=16)
    assert not auto.use_native
    assert "Background decode: PIL (fastdata did not build" in capsys.readouterr().out
    assert auto[0]["background"].shape == (32, 32, 3)
    assert not ds.LayoutDataset(zip_path, background_size=32, use_native=False).use_native
