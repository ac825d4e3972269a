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
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

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
    # jit: an interpret-mode Pallas kernel applied op by op can hang on a
    # loaded host (its callback's nested dispatches queue behind the ops
    # the eager caller has already enqueued); one executable cannot
    want = {
        flash: np.asarray(jax.jit(JaxTextEncoder(dataclasses.replace(
            jcfg, flash_attention=flash, flash_interpret=flash)).apply)({"params": params}, ids, mask))
        for flash in (False, True)
    }
    return ids, mask, params, want


@pytest.mark.parametrize("jax_flash", [False, True])
@pytest.mark.parametrize("port_flash", [False, True])
def test_text_encoder_matches_jax(case, jax_flash, port_flash):
    ids, mask, params, want = case
    c = JaxParams(params)
    c.bert_encoder("bert", "", DIMS["num_hidden_layers"])
    port = load_port(TextEncoder(BertConfig(flash_attention=port_flash, add_cross_attention=False, **DIMS)), c.finish())
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (2, 3, 32)
    assert_max_abs(got, want[jax_flash], 1e-5, f"TextEncoder port_flash={port_flash}")


def test_flash_path_needs_no_grad(case, monkeypatch):
    """With gradients recorded the port takes the plain path."""
    ids, mask, params, want = case
    c = JaxParams(params)
    c.bert_encoder("bert", "", DIMS["num_hidden_layers"])
    port = load_port(TextEncoder(BertConfig(flash_attention=True, add_cross_attention=False, **DIMS)), c.finish())
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


# ---------------------------------------------------------------------------
# the text decoder: causal BERT + LM head + label-smoothed loss
# ---------------------------------------------------------------------------

def test_extended_attention_bias_causal():
    from layoutdetr_tpu.models.bert import extended_attention_bias as jax_bias

    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.int32)
    got = extended_attention_bias(torch.from_numpy(mask), is_decoder=True)
    want = np.asarray(jax_bias(mask, True))
    assert got.shape == want.shape == (2, 1, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_head_model_and_loss_match_jax():
    """BertLMHeadModel (causal, mode='text', with hidden and attention
    dropout off) and its label-smoothed loss vs JAX, values and
    gradients, with ignored tokens and masked rows. fp32, 1e-5 (grads
    relative to each leaf's max |g|, at least 1e-3 of the largest:
    the attention key biases' true gradient is 0)."""
    from layoutdetr_tpu.models.bert import BertLMHeadModel as JaxLM
    from layoutdetr_tpu_torch.models.bert import BertLMHeadModel
    from test_torch_common import random_params

    rng = np.random.default_rng(3)
    ids = rng.integers(1, 64, (4, 12))
    mask = np.ones((4, 12), np.int32)
    mask[1, 7:] = 0
    labels = np.where(mask == 1, ids, -100)
    row_mask = np.array([True, True, False, True])
    jcfg = JaxBertConfig(**DIMS, encoder_width=16)
    model = JaxLM(jcfg)
    params = random_params(model, ids, mask, labels=labels, row_mask=row_mask)

    def loss_fn(p):
        return model.apply({"params": p}, ids, mask, labels=labels, row_mask=row_mask)

    (logits, loss), vjp = jax.vjp(loss_fn, params)
    (grads,) = vjp((np.zeros_like(logits), np.ones_like(loss)))

    c = JaxParams({"lm": params})
    c.bert_lm_head("lm", "", DIMS["num_hidden_layers"], 16)
    port = load_port(BertLMHeadModel(BertConfig(**DIMS, encoder_width=16)), c.finish())
    got_logits, got_loss = port(torch.from_numpy(ids), torch.from_numpy(mask),
                                labels=torch.from_numpy(labels),
                                row_mask=torch.from_numpy(row_mask))
    assert_max_abs(got_logits, np.asarray(logits), 1e-5, "LM logits")
    assert_max_abs(got_loss, np.asarray(loss), 1e-5, "LM loss")

    g = JaxParams({"lm": jax.tree.map(np.asarray, grads)})
    g.bert_lm_head("lm", "", DIMS["num_hidden_layers"], 16)
    want_g = g.finish()
    floor = 1e-3 * max(float(v.abs().max()) for v in want_g.values())
    names = [n for n, _ in port.named_parameters() if ".crossattention." not in n]
    got_g = torch.autograd.grad(got_loss, [dict(port.named_parameters())[n] for n in names])
    for name, gg in zip(names, got_g):
        scale = max(float(want_g[name].abs().max()), floor)
        assert float((gg - want_g[name]).abs().max()) <= 1e-5 * scale, name


def test_lm_loss_label_smoothed_matches_jax():
    from layoutdetr_tpu.models.bert import lm_loss_label_smoothed as jax_loss
    from layoutdetr_tpu_torch.models.bert import lm_loss_label_smoothed

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 10, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 10))
    labels[0, 6:] = -100
    row_mask = np.array([True, False, True])
    for rm in (None, row_mask):
        want = np.asarray(jax_loss(logits, labels, rm))
        got = lm_loss_label_smoothed(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if rm is None else torch.from_numpy(rm))
        assert_max_abs(got, want, 1e-5, f"lm loss row_mask={rm is not None}")
