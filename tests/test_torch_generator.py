"""The whole slice: port Generator (reconst=False) and layout serving vs
the JAX package at tiny dims (hidden 16, BERT 32 wide / 2 heads / 2
layers, ResNet stages (1,1,1,1), background 32, N=9, T=16), with the JAX
params carried across by generator_state_dict_from_jax. fp32; the bar on
bbox_fake is 1e-5 max-abs."""

import os

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.data.tokenizer import LayoutTokenizer as JaxTokenizer
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.serving.postprocess import apply_postprocessing as jax_postprocess
from layoutdetr_tpu.serving.postprocess import jitter as jax_jitter
from layoutdetr_tpu.utils import torch_convert
from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer
from layoutdetr_tpu_torch.generate import (
    LayoutRequest,
    generate_layouts,
    load_generator,
    main,
    save_generator,
)
from layoutdetr_tpu_torch.models.generator import Generator, make_text_feature_fn
from layoutdetr_tpu_torch.utils.convert import generator_state_dict_from_jax

from test_torch_common import (
    assert_max_abs,
    load_port,
    random_params,
    tiny_configs,
)
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5


def _batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, cfg.max_text_length
    mask = np.ones((b, n, t), np.int32)
    lens = rng.integers(2, t + 1, size=(b, n))
    mask[np.arange(t)[None, None, :] >= lens[..., None]] = 0
    padding = np.zeros((b, n), bool)
    padding[0, 4:] = True
    padding[1, 8:] = True
    return dict(
        z=rng.normal(size=(b, n, cfg.z_dim)).astype(np.float32),
        bbox_class=rng.integers(0, cfg.num_bbox_labels, size=(b, n)),
        bbox_real=rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32),
        text_ids=rng.integers(1, cfg.vocab_size, size=(b, n, t)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, cfg.text_len_table + 40, size=(b, n)),  # some clip
        padding_mask=padding,
        background=rng.normal(size=(b, cfg.background_size, cfg.background_size, 3)).astype(np.float32),
    )


def _init(jcfg, batch):
    return random_params(JaxGenerator(jcfg), **batch, reconst=True)


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def slice_case():
    jcfg, cfg = tiny_configs()
    batch = _batch(jcfg)
    params = _init(jcfg, batch)
    want = np.asarray(JaxGenerator(jcfg).apply({"params": params}, **batch))
    return cfg, batch, params, want


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad_fused", "grad_plain"])
def test_generator_matches_jax(slice_case, grad):
    cfg, batch, params, want = slice_case
    port = load_port(Generator(cfg), generator_state_dict_from_jax(params, cfg))
    with torch.set_grad_enabled(grad):
        got = port(**_torch(batch))
    assert got.shape == (2, 9, 4) and got.dtype == torch.float32
    assert_max_abs(got, want, TOL, "bbox_fake")


def test_generator_reconst_matches_jax(slice_case):
    """The training forward: bbox_fake, loss_z, logit_cls, loss_lm and
    loss_text_len (the text decoder in mode='text'), deterministic.
    1e-5 max-abs, relative above 1."""
    cfg, batch, params, _ = slice_case
    jcfg, _ = tiny_configs()
    want = [np.asarray(a) for a in JaxGenerator(jcfg).apply({"params": params}, **batch,
                                                            reconst=True)]
    port = load_port(Generator(cfg), generator_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = port(**_torch(batch), reconst=True)
    assert len(got) == 5
    for name, g, w in zip(("bbox_fake", "loss_z", "logit_cls", "loss_lm", "loss_text_len"),
                          got, want):
        assert tuple(g.shape) == w.shape, name
        assert_max_abs(g, w, TOL * max(1.0, float(np.abs(w).max())), name)


def test_generator_hoisted_text_feat(slice_case):
    cfg, batch, params, want = slice_case
    port = load_port(Generator(cfg), generator_state_dict_from_jax(params, cfg))
    tb = _torch(batch)
    text_feat = make_text_feature_fn(port.text_encoder)(tb["text_ids"], tb["text_mask"])
    with torch.no_grad():
        got = port(**tb, text_feat=text_feat)
    assert_max_abs(got, want, TOL, "bbox_fake with text_feat")


def test_state_dict_keeps_reference_names(slice_case):
    """The JAX package's torch converter reads the port's state dict back
    into the JAX params: the names are the reference networks_detr ones."""
    cfg, _, params, _ = slice_case
    sd = {k: v.numpy() for k, v in generator_state_dict_from_jax(params, cfg).items()}
    back = {
        "transformer": torch_convert.convert_detr_transformer(
            sd, cfg.num_encoder_layers, cfg.num_decoder_layers, prefix="transformer."),
        "text_encoder": {"bert": torch_convert.convert_bert_encoder(
            sd, cfg.bert_num_encoder_layers, cfg.vocab_size, prefix="text_encoder.")},
        "fc_in": torch_convert._mlp(sd, "fc_in"),
        "bbox_embed": torch_convert._mlp(sd, "bbox_embed"),
        "input_proj": torch_convert._conv1x1_as_dense(sd, "input_proj"),
        "text_decoder": torch_convert.convert_bert_lm_head(
            sd, cfg.bert_num_decoder_layers, cfg.vocab_size, prefix="text_decoder."),
        **{k: torch_convert._lin(sd, k) for k in ("fc_z_rec", "fc_out_cls", "fc_text_len_rec")},
    }
    for key, tree in back.items():
        # the port's crossattention blocks (filled; JAX creates none in mode='text')
        # come back too: compare the rest
        tree = _drop_crossattention(tree)
        jax.tree.map(np.testing.assert_array_equal, tree, params[key])


def _drop_crossattention(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _drop_crossattention(v) for k, v in tree.items() if k != "crossattention"}


def test_converter_raises_on_missing_and_extra_leaves(slice_case):
    cfg, _, params, _ = slice_case
    missing = jax.tree.map(lambda x: x, params)
    del missing["fc_z"]["bias"]
    with pytest.raises(KeyError, match="fc_z/bias"):
        generator_state_dict_from_jax(missing, cfg)
    extra = jax.tree.map(lambda x: x, params)
    extra["bbox_embed"]["layers_3"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="layers_3"):
        generator_state_dict_from_jax(extra, cfg)
    # a crossattention block the tree carries (one converted from a
    # reference checkpoint) is taken, with or without the top-level
    # "params" key; one it lacks is filled
    cross = jax.tree.map(lambda x: x, params)
    d = cfg.bert_f_dim
    block = {"self": {n: {"kernel": np.full((d, d), 0.5, np.float32), "bias": np.zeros(d, np.float32)}
                      for n in ("query", "key", "value")},
             "output_dense": {"kernel": np.zeros((d, d), np.float32), "bias": np.zeros(d, np.float32)},
             "output_layernorm": {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}}
    cross["text_encoder"]["bert"]["layer_0"]["crossattention"] = block
    sd = generator_state_dict_from_jax({"params": cross}, cfg)
    assert set(sd) == set(Generator(cfg).state_dict())
    assert (sd["text_encoder.encoder.layer.0.crossattention.self.key.weight"] == 0.5).all()
    filled = sd["text_encoder.encoder.layer.1.crossattention.self.key.weight"]
    assert 0.01 < float(filled.std()) < 0.03


# ---------------------------------------------------------------------------
# serving: generate_layouts vs the JAX generate.py flow
# ---------------------------------------------------------------------------

STRINGS = [["Summer sale", "Up to 50% off!", "Shop now"],
           ["A very long disclaimer " * 6, "", "Logo", "Sign up today", "x"]]
LABELS = [["header", "body text", "button"],
          ["disclaimer / footnote", "pre-header", "logo", "button", "callout"]]


def test_tokenizer_matches_jax(tmp_path):
    texts = [s for row in STRINGS for s in row] + ["héllo, wörld", "ALL CAPS?!", "a b c " * 20]
    port = LayoutTokenizer(max_length=16, vocab_dir=str(tmp_path), length_clip=64)
    ref = JaxTokenizer(max_length=16, vocab_dir=str(tmp_path), length_clip=64)
    assert port.backend == ref.backend == "hash"
    for got, want in zip(port.encode_batch(texts), ref.encode_batch(texts)):
        np.testing.assert_array_equal(got, want)
    assert [port.token_count(t) for t in texts] == [ref.token_count(t) for t in texts]


def test_generate_layouts_matches_jax_flow(tmp_path):
    jcfg, cfg = tiny_configs(vocab_size=30524, bos_token_id=30522, text_len_table=64)
    seed, strength = 5, 0.1
    rng = np.random.default_rng(1)
    backgrounds = [rng.normal(size=(32, 32, 3)).astype(np.float32) for _ in STRINGS]

    tok_args = dict(max_length=cfg.max_text_length, vocab_dir=str(tmp_path),
                    length_clip=cfg.text_len_table)
    g = JaxGenerator(jcfg)
    params = None
    apply = jax.jit(g.apply)
    want = []
    for i, (texts, labels) in enumerate(zip(STRINGS, LABELS)):
        # generate.py:103-145, one request at a time with seed + i
        from layoutdetr_tpu.serving.postprocess import LABEL2INDEX

        n_real = len(texts)
        ids, tmask, tlen = JaxTokenizer(**tok_args).encode_layouts([texts + [""] * (9 - n_real)])
        lab = np.array([LABEL2INDEX[x] for x in labels] + [0] * (9 - n_real), np.int64)
        mask = np.arange(9) < n_real
        inputs = dict(z=np.random.RandomState(seed + i).randn(1, 9, jcfg.z_dim).astype(np.float32),
                      bbox_class=lab[None], bbox_real=np.zeros((1, 9, 4), np.float32),
                      text_ids=ids, text_mask=tmask, text_len=tlen, padding_mask=~mask[None],
                      background=backgrounds[i][None])
        if params is None:
            params = _init(jcfg, inputs)
        raw = np.asarray(apply({"params": params}, **inputs))
        bbox, align = jax_postprocess(jax_jitter(raw, strength, seed=0), mask[None], "none",
                                      np.random.RandomState(seed + i))
        want.append((raw[0], bbox[0], align, mask))

    port = load_port(Generator(cfg), generator_state_dict_from_jax(params, cfg))
    requests = [LayoutRequest(bg, s, lab) for bg, s, lab in zip(backgrounds, STRINGS, LABELS)]
    got = generate_layouts(port, requests, seed=seed, device="cpu",
                           tokenizer=LayoutTokenizer(**tok_args), jitter_strength=strength)
    assert len(got) == 2
    for layout, (raw, bbox, align, mask) in zip(got, want):
        np.testing.assert_array_equal(layout.mask, mask)
        assert_max_abs(layout.raw, raw, TOL, "served raw bbox")
        assert_max_abs(layout.bbox, bbox, TOL, "served post-processed bbox")
        assert layout.alignment == align


def test_generate_cli_on_cpu(tmp_path):
    import json

    import PIL.Image

    _, cfg = tiny_configs(vocab_size=30524, bos_token_id=30522)
    torch.manual_seed(0)
    ckpt = str(tmp_path / "g.pt")
    save_generator(Generator(cfg), ckpt)
    model = load_generator(ckpt, device="cpu")
    assert model.cfg == cfg
    bg = tmp_path / "bg.png"
    PIL.Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 60, 3), np.uint8)).save(bg)
    out = tmp_path / "out" / "banner"
    (layout,) = main(["--ckpt", ckpt, "--bg", str(bg), "--strings", "Hello|World",
                      "--string-labels", "header|button", "--outfile", str(out),
                      "--device", "cpu", "--out-postprocessing", "horizontal_center_aligned"])
    assert os.path.isfile(str(out) + "_bboxes.png")
    with open(str(out) + ".json") as f:
        result = json.load(f)
    assert len(result["bbox_xcycwh"]) == 2 and result["alignment"] is True
    assert layout.mask.sum() == 2 and np.isfinite(layout.bbox).all()
