"""Port DETR Transformer (with_token=False, post-norm) vs the JAX
package's, with padded layout elements. fp32, 1e-5 max-abs."""

import numpy as np
import torch

import jax

from layoutdetr_tpu.models.detr_transformer import Transformer as JaxTransformer
from layoutdetr_tpu_torch.models.detr_transformer import Transformer
from layoutdetr_tpu_torch.utils.convert import JaxParams

from test_torch_common import assert_max_abs, load_port, randomize_tree, to_numpy_tree


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
