"""The port's FID InceptionV3 against the JAX package's: features at the
smallest legal input (75^2, batch 2) with JAX params crossed over by
``inception_state_dict_from_jax`` (and back by the JAX package's
``convert_inception``), the uint8 preprocessing (an antialiased bilinear
resize 1024x768 -> 299^2), pytorch-fid naming loaded without conversion
(the tests' plain torch FIDInceptionV3), and the weight files
``load_inception_params`` reads."""

import numpy as np
import pytest
import torch

import jax

from fid_inception_torch import FIDInceptionV3
from layoutdetr_tpu.models.inception import InceptionV3 as JaxInception
from layoutdetr_tpu.models.inception import preprocess_uint8 as jax_preprocess
from layoutdetr_tpu.utils.torch_convert import convert_inception
from layoutdetr_tpu_torch.models.inception import (
    FEATURE_DIM,
    InceptionV3,
    load_inception_params,
    preprocess_uint8,
)
from layoutdetr_tpu_torch.utils.convert import inception_state_dict_from_jax

from test_torch_common import load_port
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

# of max |feature|: ~94 conv layers in fp32, summed in another order by
# XLA's and torch's CPU convolutions
FEATURE_TOL = 1e-4


def inception_params(seed: int = 0) -> dict:
    """Seeded JAX InceptionV3 params (numpy), shaped by ``jax.eval_shape``:
    He-normal kernels, so activations keep their scale through the depth,
    and BN statistics around identity (variances positive)."""
    shapes = jax.eval_shape(lambda: JaxInception().init(
        jax.random.PRNGKey(0), np.zeros((1, 75, 75, 3), np.float32)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        n = rng.normal(size=shape)
        if name == "conv":
            return n * np.sqrt(2.0 / np.prod(shape[:-1]))
        if name == "bn_weight":
            return 1 + 0.1 * n
        if name == "bn_var":
            return np.abs(1 + 0.1 * n) + 0.5
        return 0.1 * n

    def walk(node, name=""):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        return np.asarray(leaf(name, node.shape), np.float32)

    return walk(shapes)


@pytest.fixture(scope="module")
def params():
    return inception_params()


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_inception_features_match_jax(params):
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: JaxInception().apply({"params": p}, a))(params, x))
    port = load_port(InceptionV3(), inception_state_dict_from_jax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, FEATURE_DIM) and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.1  # the features carry signal, not a vanished activation
    assert np.abs(got - want).max() <= FEATURE_TOL * scale
    # the port's state dict reads back into JAX's params bit for bit
    back = convert_inception({k: v.numpy() for k, v in port.state_dict().items()})
    mine, theirs = _flat(back), _flat(params)
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_preprocess_matches_jax():
    """1024x768 -> 299^2 (and a 64^2 upsample) against JAX's, to 1e-5 on
    the resized image in [0, 1], before the map to [-1, 1] doubles every
    difference. Most of the gap is JAX's: its fp32 contraction lies up to
    1.3e-5 (on [-1, 1]) from a float64 contraction of its own weight
    matrices, ``F.interpolate``'s 4.7e-7."""
    for shape in ((2, 768, 1024, 3), (1, 64, 64, 3)):
        imgs = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
        got = preprocess_uint8(torch.from_numpy(imgs)).numpy()
        assert got.shape == (shape[0], 3, 299, 299) and got.dtype == np.float32
        want = np.asarray(jax_preprocess(imgs)).transpose(0, 3, 1, 2)
        assert np.abs((got + 1.0) / 2.0 - (want + 1.0) / 2.0).max() <= 1e-5


def test_pytorch_fid_naming_loads_without_conversion(tmp_path):
    """A pytorch-fid-named state dict (BatchNorm's num_batches_tracked, an
    fc head, a {"state_dict": ...} wrapper) loads as it is and computes the
    plain torch FID network's features."""
    torch.manual_seed(0)
    ref = FIDInceptionV3().eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)
                m.running_mean.normal_(0, 0.1)
    sd = dict(ref.state_dict(), **{"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    torch.save({"state_dict": sd}, tmp_path / "pt_inception.pth")
    port = load_inception_params(str(tmp_path / "pt_inception.pth"), device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 3, 80, 80)).astype(np.float32))
    with torch.inference_mode():
        want, got = ref(x), port(x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_load_inception_params_forms(params, tmp_path):
    """A JAX .npz of flattened 'a/b/c' keys and an in-memory JAX tree load
    to the same weights; an orbax directory is refused with the way out."""
    flat = {}
    for block, node in params.items():
        for k, v in node.items():
            if isinstance(v, dict):
                flat.update({f"{block}/{k}/{leaf}": a for leaf, a in v.items()})
            else:
                flat[f"{block}/{k}"] = v
    np.savez(tmp_path / "inc.npz", **flat)
    from_npz = load_inception_params(str(tmp_path / "inc.npz"), device="cpu").state_dict()
    from_tree = load_inception_params({"params": params}, device="cpu").state_dict()
    assert from_npz.keys() == from_tree.keys()
    assert all(torch.equal(from_npz[k], from_tree[k]) for k in from_npz)
    with pytest.raises(ValueError, match="14c"):
        load_inception_params(str(tmp_path), device="cpu")
