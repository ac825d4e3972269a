"""Port TextEncoder vs the JAX package's, with and without the fused
attention (JAX's Pallas kernel in interpret mode; the port's wrapper on
CPU tensors, i.e. its plain version). Dims of tests/test_attention.py.
fp32, 1e-5 max-abs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.bert import BertConfig as JaxBertConfig
from layoutdetr_tpu.models.generator import TextEncoder as JaxTextEncoder
from layoutdetr_tpu_torch.config import BertConfig
from layoutdetr_tpu_torch.models.bert import TextEncoder, extended_attention_bias
from layoutdetr_tpu_torch.utils.convert import JaxParams

from test_torch_common import assert_max_abs, load_port, randomize_tree, to_numpy_tree

DIMS = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 64, (2, 3, 16))
    mask = np.ones((2, 3, 16), np.int32)
    mask[0, 0, 10:] = 0
    mask[1, 2, 2:] = 0
    jcfg = JaxBertConfig(add_cross_attention=False, **DIMS)
    params = to_numpy_tree(JaxTextEncoder(jcfg).init(jax.random.PRNGKey(0), ids, mask)["params"])
    params = randomize_tree(params, scale=0.02)
    want = {
        flash: np.asarray(JaxTextEncoder(dataclasses.replace(
            jcfg, flash_attention=flash, flash_interpret=flash)).apply({"params": params}, ids, mask))
        for flash in (False, True)
    }
    return ids, mask, params, want


@pytest.mark.parametrize("jax_flash", [False, True])
@pytest.mark.parametrize("port_flash", [False, True])
def test_text_encoder_matches_jax(case, jax_flash, port_flash):
    ids, mask, params, want = case
    c = JaxParams(params)
    c.bert_encoder("bert", "", DIMS["num_hidden_layers"])
    port = load_port(TextEncoder(BertConfig(flash_attention=port_flash, **DIMS)), c.finish())
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (2, 3, 32)
    assert_max_abs(got, want[jax_flash], 1e-5, f"TextEncoder port_flash={port_flash}")


def test_flash_path_needs_no_grad(case, monkeypatch):
    """With gradients recorded the port takes the plain path."""
    ids, mask, params, want = case
    c = JaxParams(params)
    c.bert_encoder("bert", "", DIMS["num_hidden_layers"])
    port = load_port(TextEncoder(BertConfig(flash_attention=True, **DIMS)), c.finish())
    calls = []
    import layoutdetr_tpu_torch.models.bert as bert_mod

    real = bert_mod.fused_attention
    monkeypatch.setattr(bert_mod, "fused_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert calls == [] and got.requires_grad
    with torch.no_grad():
        port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == DIMS["num_hidden_layers"]
    assert_max_abs(got, want[False], 1e-5, "TextEncoder with grad")


def test_extended_attention_bias():
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]])
    bias = extended_attention_bias(mask)
    assert bias.shape == (2, 1, 1, 3) and bias.dtype == torch.float32
    assert bias[0, 0, 0].tolist() == [0.0, 0.0, -10000.0]
