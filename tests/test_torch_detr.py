"""Port DETR Transformer (post-norm; with_token False for G, True for D's
conditional critic) and D's TransformerWithTokenEncoder vs the JAX
package's, with padded layout elements. fp32, 1e-5 max-abs."""

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.detr_transformer import Transformer as JaxTransformer
from layoutdetr_tpu_torch.models.detr_transformer import Transformer
from layoutdetr_tpu_torch.utils.convert import JaxParams

from test_torch_common import assert_max_abs, load_port, randomize_tree, to_numpy_tree
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def test_transformer_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    pos = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    tgt = rng.normal(size=(2, 9, 16)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[0, 3:] = True
    pad[1, 7:] = True

    jm = JaxTransformer(d_model=16, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
                        dim_feedforward=32)
    params = jm.init(jax.random.PRNGKey(0), src, None, pos, tgt, pad)["params"]
    params = randomize_tree(to_numpy_tree(params), scale=0.05)
    want_hs, want_mem = (np.asarray(a) for a in jm.apply({"params": params}, src, None, pos, tgt, pad))

    c = JaxParams(params)
    c.transformer("", "", 2, 2)
    port = load_port(Transformer(16, 2, 2, 2, 32), c.finish())
    hs, mem = port(torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(tgt),
                   torch.from_numpy(pad))
    assert hs.shape == (2, 9, 16) and mem.shape == (2, 2, 3, 16)
    assert_max_abs(hs, want_hs, 1e-5, "decoder output")
    assert_max_abs(mem, want_mem, 1e-5, "encoder memory")


def test_transformer_with_token_matches_jax():
    """D's conditional critic: the CLS token prepended to the queries."""
    rng = np.random.default_rng(1)
    src = rng.normal(size=(2, 2, 2, 16)).astype(np.float32)
    pos = rng.normal(size=(2, 2, 2, 16)).astype(np.float32)
    tgt = rng.normal(size=(2, 5, 16)).astype(np.float32)
    pad = np.array([[False, False, True, True, True], [False] * 5])
    jm = JaxTransformer(d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=2,
                        dim_feedforward=32, with_token=True)
    params = randomize_tree(to_numpy_tree(
        jm.init(jax.random.PRNGKey(0), src, None, pos, tgt, pad)["params"]), scale=0.05)
    want_hs, _ = (np.asarray(a) for a in jm.apply({"params": params}, src, None, pos, tgt, pad))
    c = JaxParams(params)
    c.transformer("", "", 1, 2)
    port = load_port(Transformer(16, 2, 1, 2, 32, with_token=True), c.finish())
    hs, _ = port(torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(tgt),
                 torch.from_numpy(pad))
    assert hs.shape == (2, 6, 16)
    assert_max_abs(hs, want_hs, 1e-5, "with_token decoder output")


def test_transformer_with_token_encoder_matches_jax():
    """D's unconditional critic (torch encoder layers + CLS token) and the
    TorchEncoderLayer inside it, with padded elements."""
    from layoutdetr_tpu.models.detr_transformer import (
        TransformerWithTokenEncoder as JaxTokenEncoder,
    )
    from layoutdetr_tpu_torch.models.detr_transformer import TransformerWithTokenEncoder

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[0, 3:] = True
    jm = JaxTokenEncoder(16, nhead=2, dim_feedforward=32, num_layers=2)
    params = randomize_tree(to_numpy_tree(jm.init(jax.random.PRNGKey(0), x, pad)["params"]),
                            scale=0.05)
    want = np.asarray(jm.apply({"params": params}, x, pad))
    c = JaxParams(params)
    c.put("token", c.take("token"))
    for i in range(2):
        c.torch_encoder_layer(f"layers_{i}", f"core.layers.{i}")
    port = load_port(TransformerWithTokenEncoder(16, 2, 32, 2), c.finish())
    got = port(torch.from_numpy(x), torch.from_numpy(pad))
    assert got.shape == (2, 10, 16)
    assert_max_abs(got, want, 1e-5, "TransformerWithTokenEncoder")


def test_dropout_is_seeded_and_off_when_deterministic():
    """Training-mode dropout draws its masks from the generator passed in."""
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.normal(size=(2, 2, 2, 16)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(2, 5, 16)).astype(np.float32))
    pad = torch.zeros(2, 5, dtype=torch.bool)
    torch.manual_seed(0)
    port = Transformer(16, 2, 1, 1, 32)
    run = lambda seed: port(src, src, tgt, pad, deterministic=False,
                            generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(port(src, src, tgt, pad)[0], port(src, src, tgt, pad, deterministic=True)[0])
    with pytest.raises(ValueError, match="Generator"):
        port(src, src, tgt, pad, deterministic=False)
