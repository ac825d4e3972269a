"""Helpers for the PyTorch-port tests, and the port's import hygiene.

The port (``layoutdetr_tpu_torch``) is held against the JAX package at
small sizes: the same numpy-seeded inputs go through both, JAX params
are carried across with ``layoutdetr_tpu_torch.utils.convert``, and the
outputs are compared by max-abs difference.
"""

import ast
import dataclasses
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


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the smoke script fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
