"""Helpers for the PyTorch-port tests, and the port's import hygiene.

The port (``layoutdetr_tpu_torch``) is held against the JAX package at
small sizes: the same numpy-seeded inputs go through both, JAX params
are carried across with ``layoutdetr_tpu_torch.utils.convert``, and the
outputs are compared by max-abs difference.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO_ROOT, "layoutdetr_tpu_torch")
FORBIDDEN = ("jax", "flax", "layoutdetr_tpu")

# Tiny but complete Generator dims, shared by both sides.
TINY_KW = dict(
    z_dim=4, num_bbox_labels=8, max_elements=9, hidden_dim=16, bert_f_dim=32,
    bert_num_heads=2, bert_num_encoder_layers=2, bert_num_decoder_layers=1, im_f_dim=16,
    max_text_length=16, vocab_size=64, bos_token_id=62, nhead=2, num_encoder_layers=1,
    num_decoder_layers=2, dim_feedforward=32, background_size=32,
    backbone_stage_sizes=(1, 1, 1, 1), bert_intermediate_size=64,
    bert_max_position_embeddings=32,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the length of a port test module, restored
    after it. The suite runs several test processes at once on a few cores;
    one torch thread each keeps the host from being oversubscribed (the JAX
    tests' Pallas interpret mode stalls on an overloaded host). Each port
    test module imports this fixture, which makes it apply there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_native_command():
    """The JAX package's build of its native decoder, read from its source
    (``layoutdetr_tpu/data/native.py``, ``_build``): ``(compiler, flags,
    libs)`` around ``-o <lib> <src>``."""
    from layoutdetr_tpu.data import native as jax_native

    build = next(n for n in ast.parse(inspect.getsource(jax_native)).body
                 if isinstance(n, ast.FunctionDef) and n.name == "_build")
    call = next(n for n in ast.walk(build)
                if isinstance(n, ast.List) and n.elts and isinstance(n.elts[0], ast.Constant))
    words = [e.value if isinstance(e, ast.Constant) else e.id for e in call.elts]
    out, src = words.index("_SO"), words.index("_SRC")
    assert words[out - 1] == "-o" and src == out + 1, words
    return words[0], tuple(words[1:out - 1]), tuple(words[src + 1:])


@pytest.fixture(scope="module")
def jax_native_private():
    """The JAX package's native decoder loaded from a private build of its
    own source, for the length of a port test module; returns its path.

    JAX's loader compiles ``native/libfastdata.so`` in place once a process
    finds it missing or older than its source, and tries once a process.
    Test workers load it at once while they collect (``tests/test_native.py``
    asks at import), so one of them can open a file another is still
    writing ("file too short") and then has no JAX decoder for its whole
    life. Here the same source and command go through the port's
    ``_build._compile`` (a temporary file and ``os.replace``, named by a
    hash under ``build/kernels/``), so the bits are JAX's and no test
    process reads a half-written library."""
    from layoutdetr_tpu.data import native as jax_native
    from layoutdetr_tpu_torch.ops import _build

    compiler, flags, libs = jax_native_command()
    path = _build._compile(jax_native._SRC, compiler, flags, libs)
    if os.path.getmtime(path) < os.path.getmtime(jax_native._SRC):
        # a library reused after a checkout touched the source is still its
        # build; left older, JAX's loader would rebuild it in place
        os.utime(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", path)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.available(), path
        yield path


def to_numpy_tree(tree):
    """JAX variables/params -> nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def randomize_tree(tree, seed=0, scale=0.1):
    """Add seeded noise to every leaf, so that zero/one inits (biases,
    norms, BN statistics) are exercised too; variances stay positive."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        noise = rng.normal(scale=scale, size=node.shape).astype(np.float32)
        if key == "running_var":
            return np.abs(node + noise) + 0.5
        return (node + noise).astype(np.float32)

    return walk(tree)


def _random_leaf(path, shape, rng):
    """A plausible random value for a JAX param leaf, by its name: unit
    LayerNorm scales and BN statistics, fan-in scaled kernels, N(0, 1)
    StyleGAN weights (x 100 in the lr-0.01 mapping net), BERT's 0.02
    embeddings, and 0.1-sized biases (about 1 for the StyleGAN affines)."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    n = rng.normal(size=shape)
    if parent.startswith("bn") or parent == "downsample_bn":
        if name == "weight":
            return 1 + 0.1 * n
        return np.abs(1 + 0.1 * n) + 0.5 if name == "running_var" else 0.1 * n
    if name == "scale":
        return 1 + 0.1 * n
    if name in ("kernel", "in_proj_kernel", "out_kernel"):
        return n / np.sqrt(np.prod(shape[:-1]))
    if name == "weight":
        return n * (100.0 if "mapping" in path else 1.0)
    if name == "pos_token":
        return rng.uniform(size=shape)
    if name in ("word_embeddings", "position_embeddings"):
        return 0.02 * n
    if name in ("const", "token", "emb_label", "emb_label_uncond", "enc_text_len"):
        return n
    if name == "bias" and "affine" in path:
        return 1 + 0.1 * n
    return 0.1 * n


def random_params(module, *args, seed=0, **kwargs):
    """Seeded numpy params for a flax module, shaped by ``jax.eval_shape``
    of its init (no init compile): nested dicts of float32 arrays."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: module.init({"params": key, "dropout": key, "noise": key}, *args, **kwargs))
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return np.asarray(_random_leaf(path, node.shape, rng), np.float32)

    return walk(shapes["params"], ())


def load_port(module, state_dict):
    """strict load of a converted state dict; returns the module in eval mode."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def max_abs(got, want):
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got.astype(np.float32) - np.asarray(want, np.float32))))


def assert_max_abs(got, want, tol, what=""):
    err = max_abs(got, want)
    assert err <= tol, f"{what} max-abs {err:.3e} > {tol:.1e}"


def tiny_configs(**overrides):
    """(JAX GeneratorConfig, port GeneratorConfig) with the same fields."""
    from layoutdetr_tpu.models.generator import GeneratorConfig as JaxCfg

    from layoutdetr_tpu_torch.config import GeneratorConfig

    jcfg = JaxCfg(**{**TINY_KW, **overrides})
    return jcfg, GeneratorConfig.from_dict(dataclasses.asdict(jcfg))


# The serving entries' spans, in the order a call runs them.
GENERATE_SPANS = ["generate.encode", "generate.upload", "generate.forward", "generate.download",
                  "generate.postprocess"]


def profiled_ranges(fn, prefix: str):
    """``fn()`` under the CPU profiler: (its result, [(name, start_ns,
    end_ns)] of the recorded ranges whose names start with ``prefix``, in
    start order)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(prefix) and ev.activity_type() == "user_annotation")
    return out, [(name, s, e) for s, e, name in ranges]


def assert_in_turn(ranges, names):
    """``ranges`` (``profiled_ranges``'s) are ``names``, once each, in this
    order, none overlapping the next."""
    assert [r[0] for r in ranges] == list(names)
    for (_, _, end), (_, start, _) in zip(ranges, ranges[1:]):
        assert end <= start


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def _port_files():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_port_file_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_prefix_spares_the_port():
    assert _forbidden("layoutdetr_tpu.models") and _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("layoutdetr_tpu_torch.models") and not _forbidden("jaxlib_like")


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'layoutdetr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import layoutdetr_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'layoutdetr_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_port_test_modules_run_torch_on_one_thread():
    """Every port test module imports the fixture that sets one torch thread."""
    assert torch.get_num_threads() == 1
    for name in sorted(os.listdir(os.path.dirname(__file__))):
        if name.startswith("test_torch_") and name.endswith(".py") and name != "test_torch_common.py":
            with open(os.path.join(os.path.dirname(__file__), name)) as f:
                assert "import one_torch_thread" in f.read(), name


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the smoke script fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_tests_reach_jax_native_only_through_the_private_build():
    """A port test module that reaches the JAX package's native decoder (its
    module, or its dataset, which asks the decoder when ``use_native`` is
    left to it) uses ``jax_native_private``."""
    here = os.path.dirname(__file__)
    reach = ("layoutdetr_tpu.data import native", "layoutdetr_tpu.data.native", "JaxDataset(")
    users = []
    for name in sorted(os.listdir(here)):
        if name.startswith(("test_torch_", "_torch_")) and name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                text = f.read()
            if any(r in text for r in reach) and name != "test_torch_common.py":
                users.append(name)
                assert "jax_native_private" in text, name
    assert "test_torch_native.py" in users and "test_torch_evaluate.py" in users, users
