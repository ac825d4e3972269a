"""JAX param tree -> port state dict; a JAX training state -> port snapshot.

``generator_state_dict_from_jax`` and ``discriminator_state_dict_from_jax``
take the JAX Generator's / Discriminator's parameters (the ``params``
tree of ``init`` or of an orbax checkpoint, as nested dicts of numpy
arrays), ``layoutganpp_generator_state_dict_from_jax`` and
``layoutganpp_discriminator_state_dict_from_jax`` those of the LayoutGAN++
pair, ``layoutnet_state_dict_from_jax`` and
``inception_state_dict_from_jax`` those of the metric networks, and
return a ``state_dict`` that the port module's
``load_state_dict(..., strict=True)`` accepts, under the reference's
networks_detr names (the JAX tree's, dotted, where the repository holds
no reference state dict: the ViT and LayoutGAN++). Conventions converted
(the inverse of the JAX package's torch converter):

- Dense kernel [in, out] -> Linear weight [out, in];
- conv kernel HWIO -> OIHW; ``input_proj`` Dense [C, D] -> 1x1 conv
  [D, C, 1, 1] (C 2048 for the ResNet, 768 for the ViT);
- LayerNorm scale/bias -> weight/bias;
- attention in_proj_kernel [D, 3D] -> in_proj_weight [3D, D],
  out_kernel/out_bias -> out_proj.weight/bias;
- StyleGAN2 FullyConnectedLayer weight [in, out] -> [out, in] (the
  encoder epilogue's ``fc`` rows are already in NCHW flatten order), conv
  weights HWIO -> OIHW, ``const`` [r, r, C] -> [C, r, r]; the
  reconstruction decoders' ``pos_token`` [max_bbox, D] -> [max_bbox, 1, D]
  (LayoutGAN++'s stays [max_bbox, f_dim]).

Every leaf is consumed; a missing one raises, and so does any leaf left
over. One exception: a BERT layer's ``crossattention`` block, which the
port holds for the reference's state dict but mode='text' never runs.
The JAX modules create it only in mode='multimodal', so a JAX-initialized
tree lacks it; then it is filled with BERT's init (weights N(0, 0.02)
from a fixed seed, zero biases, unit LayerNorms), as the JAX package's
torch converter fills added vocabulary rows. A tree converted from a
reference checkpoint carries it and it is taken as is.

``JaxParams`` does the same for one submodule at a time.

``snapshot_from_jax`` converts a whole JAX ``GANTrainState``
(``layoutdetr_tpu/training/train_step.py:40-59``, as an orbax restore
gives it: nested dicts and lists of numpy arrays) into the port's training
snapshot (``utils.checkpoint.SNAPSHOT_KEYS``): the three weight sets, both
optimizer states, ``step`` and ``pl_mean``. The optimizer states are
optax's Adam moments (``multi_transform``: Adam on the trainable leaves,
``set_to_zero`` on the frozen ones) turned into ``torch.optim.Adam`` state
dicts: each moment goes through the same per-leaf conversion as its weight
(the moment trees are converted by the weight converters themselves),
``step`` is optax's one ``count``, parameters are in the port optimizer's
order, and a parameter that is no JAX leaf (a filled ``crossattention``
block, which gets no gradient) has no state, as after a port step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.stylegan2 import encoder_resolutions


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _src(*parts: str) -> str:
    return "/".join(p for p in parts if p)


def _dst(*parts: str) -> str:
    return ".".join(p for p in parts if p)


class JaxParams:
    """Consumes leaves of a JAX param tree into a port state dict.

    Source paths are '/'-joined JAX names, destinations '.'-joined port
    names; an empty prefix means the root."""

    def __init__(self, params: dict):
        if set(params) == {"params"}:
            params = params["params"]
        self.flat = {"/".join(p): np.asarray(v, np.float32) for p, v in _flatten(params)}
        self.sd: Dict[str, torch.Tensor] = {}
        self.filled: set = set()  # names put from no JAX leaf
        self._fill_rng = np.random.default_rng(0)  # crossattention blocks the tree lacks

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"JAX params lack {path!r}")
        return self.flat.pop(path)

    def put(self, name: str, arr: np.ndarray):
        self.sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    def finish(self) -> Dict[str, torch.Tensor]:
        """The state dict; raises if a leaf is left."""
        extra = sorted(self.flat)
        if extra:
            raise KeyError(f"JAX params hold leaves the port does not take: {extra}")
        return self.sd

    # -- leaves ---------------------------------------------------------
    def dense(self, src: str, dst: str):
        self.put(_dst(dst, "weight"), self.take(_src(src, "kernel")).T)
        self.put(_dst(dst, "bias"), self.take(_src(src, "bias")))

    def layernorm(self, src: str, dst: str):
        self.put(_dst(dst, "weight"), self.take(_src(src, "scale")))
        self.put(_dst(dst, "bias"), self.take(_src(src, "bias")))

    def conv(self, src: str, dst: str, leaf: str = "kernel"):
        self.put(_dst(dst, "weight"), self.take(_src(src, leaf)).transpose(3, 2, 0, 1))

    def frozen_bn(self, src: str, dst: str):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.put(_dst(dst, leaf), self.take(_src(src, leaf)))

    def mha(self, src: str, dst: str):
        self.put(_dst(dst, "in_proj_weight"), self.take(_src(src, "in_proj_kernel")).T)
        self.put(_dst(dst, "in_proj_bias"), self.take(_src(src, "in_proj_bias")))
        self.put(_dst(dst, "out_proj.weight"), self.take(_src(src, "out_kernel")).T)
        self.put(_dst(dst, "out_proj.bias"), self.take(_src(src, "out_bias")))

    def mlp(self, src: str, dst: str, num_layers: int = 3):
        for i in range(num_layers):
            self.dense(_src(src, f"layers_{i}"), _dst(dst, f"layers.{i}"))

    # -- modules --------------------------------------------------------
    def resnet(self, src: str, dst: str, stage_sizes: Sequence[int]):
        self.conv(_src(src, "conv1"), _dst(dst, "conv1"))
        self.frozen_bn(_src(src, "bn1"), _dst(dst, "bn1"))
        for stage, blocks in enumerate(stage_sizes, start=1):
            for blk in range(blocks):
                s, d = _src(src, f"layer{stage}_{blk}"), _dst(dst, f"layer{stage}.{blk}")
                for i in (1, 2, 3):
                    self.conv(f"{s}/conv{i}", f"{d}.conv{i}")
                    self.frozen_bn(f"{s}/bn{i}", f"{d}.bn{i}")
                if blk == 0:
                    self.conv(f"{s}/downsample_conv", f"{d}.downsample.0")
                    self.frozen_bn(f"{s}/downsample_bn", f"{d}.downsample.1")

    def vit_blocks(self, src: str, dst: str):
        """As many ``blocks_{i}`` as the tree holds -> ``blocks.{i}``."""
        i = 0
        while _src(src, f"blocks_{i}/qkv/kernel") in self.flat:
            s, d = _src(src, f"blocks_{i}"), _dst(dst, f"blocks.{i}")
            for name in ("norm1", "norm2"):
                self.layernorm(f"{s}/{name}", f"{d}.{name}")
            for name in ("qkv", "proj", "fc1", "fc2"):
                self.dense(f"{s}/{name}", f"{d}.{name}")
            i += 1

    def vit(self, src: str, dst: str):
        """JAX ``VisionTransformer`` -> port ``VisionTransformer``: the patch
        kernel HWIO -> OIHW, ``pos_embed`` as it is."""
        self.conv(_src(src, "patch_embed"), _dst(dst, "patch_embed"))
        self.put(_dst(dst, "patch_embed.bias"), self.take(_src(src, "patch_embed/bias")))
        self.put(_dst(dst, "pos_embed"), self.take(_src(src, "pos_embed")))
        self.vit_blocks(src, dst)
        self.layernorm(_src(src, "norm"), _dst(dst, "norm"))

    def bert_encoder(self, src: str, dst: str, num_layers: int,
                     encoder_width: Optional[int] = None):
        """JAX ``BertModel`` params -> port ``BertModel``/``TextEncoder``;
        with ``encoder_width`` (``add_cross_attention``) each layer's
        ``crossattention`` is taken or, when absent, filled."""
        emb = _src(src, "embeddings")
        self.put(_dst(dst, "embeddings.word_embeddings.weight"), self.take(f"{emb}/word_embeddings"))
        self.put(_dst(dst, "embeddings.position_embeddings.weight"),
                 self.take(f"{emb}/position_embeddings"))
        self.layernorm(f"{emb}/layernorm", _dst(dst, "embeddings.LayerNorm"))
        for i in range(num_layers):
            s, d = _src(src, f"layer_{i}"), _dst(dst, f"encoder.layer.{i}")
            for name in ("query", "key", "value"):
                self.dense(f"{s}/attention/self/{name}", f"{d}.attention.self.{name}")
            self.dense(f"{s}/attention/output_dense", f"{d}.attention.output.dense")
            self.layernorm(f"{s}/attention/output_layernorm", f"{d}.attention.output.LayerNorm")
            self.dense(f"{s}/intermediate_dense", f"{d}.intermediate.dense")
            self.dense(f"{s}/output_dense", f"{d}.output.dense")
            self.layernorm(f"{s}/output_layernorm", f"{d}.output.LayerNorm")
            if encoder_width is not None:
                self._crossattention(f"{s}/crossattention", f"{d}.crossattention",
                                     self.sd[f"{d}.attention.self.query.weight"].shape[0],
                                     encoder_width)

    def _crossattention(self, src: str, dst: str, hidden: int, encoder_width: int):
        if f"{src}/self/query/kernel" in self.flat:
            for name in ("query", "key", "value"):
                self.dense(f"{src}/self/{name}", f"{dst}.self.{name}")
            self.dense(f"{src}/output_dense", f"{dst}.output.dense")
            self.layernorm(f"{src}/output_layernorm", f"{dst}.output.LayerNorm")
            return
        rng = self._fill_rng
        for name, cin in (("query", hidden), ("key", encoder_width), ("value", encoder_width),
                          ("dense", hidden)):
            leaf = f"{dst}.output.dense" if name == "dense" else f"{dst}.self.{name}"
            self.put(f"{leaf}.weight", rng.normal(0.0, 0.02, (hidden, cin)).astype(np.float32))
            self.put(f"{leaf}.bias", np.zeros(hidden, np.float32))
        self.put(f"{dst}.output.LayerNorm.weight", np.ones(hidden, np.float32))
        self.put(f"{dst}.output.LayerNorm.bias", np.zeros(hidden, np.float32))
        self.filled.update(k for k in self.sd if k.startswith(f"{dst}."))

    def bert_lm_head(self, src: str, dst: str, num_layers: int, encoder_width: int):
        """JAX ``BertLMHeadModel`` -> port ``BertLMHeadModel``."""
        self.bert_encoder(_src(src, "bert"), _dst(dst, "bert"), num_layers, encoder_width)
        cls = _dst(dst, "cls.predictions")
        self.dense(_src(src, "cls/transform_dense"), f"{cls}.transform.dense")
        self.layernorm(_src(src, "cls/transform_layernorm"), f"{cls}.transform.LayerNorm")
        self.dense(_src(src, "cls/decoder"), f"{cls}.decoder")

    def torch_encoder_layer(self, src: str, dst: str):
        self.mha(f"{src}/self_attn", f"{dst}.self_attn")
        for name in ("linear1", "linear2"):
            self.dense(f"{src}/{name}", f"{dst}.{name}")
        for name in ("norm1", "norm2"):
            self.layernorm(f"{src}/{name}", f"{dst}.{name}")

    def fully_connected(self, src: str, dst: str):
        """StyleGAN2 FullyConnectedLayer: weight [in, out] -> [out, in]."""
        self.put(_dst(dst, "weight"), self.take(_src(src, "weight")).T)
        self.put(_dst(dst, "bias"), self.take(_src(src, "bias")))

    def stylegan2_decoder(self, src: str, dst: str, resolutions: Sequence[int], mapping_layers=8):
        for i in range(mapping_layers):
            self.fully_connected(_src(src, f"mapping/fc{i}"), _dst(dst, f"mapping.fc{i}"))
        for res in resolutions:
            s, d = _src(src, f"synthesis/b{res}"), _dst(dst, f"synthesis.b{res}")
            if res == resolutions[0]:
                self.put(f"{d}.const", self.take(f"{s}/const").transpose(2, 0, 1))
            for layer in (("conv1", "torgb") if res == resolutions[0] else ("conv0", "conv1", "torgb")):
                self.conv(f"{s}/{layer}", f"{d}.{layer}", leaf="weight")
                self.put(f"{d}.{layer}.bias", self.take(f"{s}/{layer}/bias"))
                self.fully_connected(f"{s}/{layer}/affine", f"{d}.{layer}.affine")

    def conv2d_layer(self, src: str, dst: str, bias: bool = True):
        """StyleGAN2 Conv2dLayer: weight HWIO -> OIHW, and its bias."""
        self.conv(src, dst, leaf="weight")
        if bias:
            self.put(_dst(dst, "bias"), self.take(_src(src, "bias")))

    def stylegan2_encoder(self, src: str, dst: str, img_resolution: int,
                          architecture: str = "resnet"):
        """JAX StyleGAN2 ``Encoder`` -> port ``Encoder``: blocks ``b{res}``
        (``fromrgb``, ``skip`` without bias, ``conv0``, ``conv1``) and the
        epilogue ``b4`` (``conv``, ``fc``, ``out``)."""
        resolutions = encoder_resolutions(img_resolution)
        for res in resolutions:
            s, d = _src(src, f"b{res}"), _dst(dst, f"b{res}")
            if res == resolutions[0] or architecture == "skip":
                self.conv2d_layer(f"{s}/fromrgb", f"{d}.fromrgb")
            if architecture == "resnet":
                self.conv2d_layer(f"{s}/skip", f"{d}.skip", bias=False)
            for name in ("conv0", "conv1"):
                self.conv2d_layer(f"{s}/{name}", f"{d}.{name}")
        s, d = _src(src, "b4"), _dst(dst, "b4")
        if architecture == "skip":
            self.conv2d_layer(f"{s}/fromrgb", f"{d}.fromrgb")
        self.conv2d_layer(f"{s}/conv", f"{d}.conv")
        for name in ("fc", "out"):
            self.fully_connected(f"{s}/{name}", f"{d}.{name}")

    def transformer(self, src: str, dst: str, num_encoder_layers: int, num_decoder_layers: int):
        for i in range(num_encoder_layers):
            s, d = _src(src, f"encoder_layers_{i}"), _dst(dst, f"encoder.layers.{i}")
            self.mha(f"{s}/self_attn", f"{d}.self_attn")
            for name in ("linear1", "linear2"):
                self.dense(f"{s}/{name}", f"{d}.{name}")
            for name in ("norm1", "norm2"):
                self.layernorm(f"{s}/{name}", f"{d}.{name}")
        for i in range(num_decoder_layers):
            s, d = _src(src, f"decoder_layers_{i}"), _dst(dst, f"decoder.layers.{i}")
            self.mha(f"{s}/self_attn", f"{d}.self_attn")
            self.mha(f"{s}/multihead_attn", f"{d}.multihead_attn")
            for name in ("linear1", "linear2"):
                self.dense(f"{s}/{name}", f"{d}.{name}")
            for name in ("norm1", "norm2", "norm3"):
                self.layernorm(f"{s}/{name}", f"{d}.{name}")
        self.layernorm(_src(src, "decoder_norm"), _dst(dst, "decoder.norm"))
        if _src(src, "token") in self.flat:  # with_token
            self.put(_dst(dst, "token"), self.take(_src(src, "token")))

    def reconst_decoder(self, src: str, fc_in: str, pos_token: str, stack: str, num_layers: int):
        """JAX ``_ReconstDecoder`` -> the port's top-level ``pos_token``
        [max_bbox, 1, D], ``dec_fc_in`` and ``<stack>.layers.{i}``."""
        self.put(pos_token, self.take(f"{src}/pos_token")[:, None, :])
        self.dense(f"{src}/dec_fc_in", fc_in)
        for i in range(num_layers):
            self.torch_encoder_layer(f"{src}/dec_layers_{i}", f"{stack}.layers.{i}")

    def image_stem(self, cfg: GeneratorConfig):
        """The image backbone (``cfg.backbone``: the ViT for 'vit', else the
        ResNet50) + ``input_proj`` (Dense [C, D] -> 1x1 conv)."""
        if cfg.backbone == "vit":
            self.vit("backbone", "backbone")
        else:
            self.resnet("backbone", "backbone.0.body", cfg.backbone_stage_sizes)
        self.put("input_proj.weight", self.take("input_proj/kernel").T[:, :, None, None])
        self.put("input_proj.bias", self.take("input_proj/bias"))


def generator_state_dict_from_jax(params: dict, cfg: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params (with or without the top ``params`` key)
    -> port ``Generator`` state dict for ``cfg``."""
    c = JaxParams(params)
    _generator_leaves(c, cfg)
    return c.finish()


def _generator_leaves(c: JaxParams, cfg: GeneratorConfig) -> None:
    c.image_stem(cfg)
    c.dense("fc_z", "fc_z")
    c.put("emb_label.weight", c.take("emb_label"))
    c.put("enc_text_len.weight", c.take("enc_text_len"))
    c.mlp("fc_in", "fc_in")
    c.bert_encoder("text_encoder/bert", "text_encoder", cfg.bert_num_encoder_layers,
                   cfg.encoder_bert_config().encoder_width)
    c.transformer("transformer", "transformer", cfg.num_encoder_layers, cfg.num_decoder_layers)
    c.mlp("bbox_embed", "bbox_embed")
    for name in ("fc_z_rec", "fc_out_cls", "fc_text_len_rec"):
        c.dense(name, name)
    c.bert_lm_head("text_decoder", "text_decoder", cfg.bert_num_decoder_layers,
                   cfg.decoder_bert_config().encoder_width)


def _decoder_resolutions(size: int) -> list:
    return [2 ** i for i in range(2, int(np.log2(size)) + 1)]


def discriminator_state_dict_from_jax(params: dict, cfg: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params (with or without the top ``params``
    key) -> port ``Discriminator`` state dict for ``cfg``."""
    c = JaxParams(params)
    _discriminator_leaves(c, cfg)
    return c.finish()


def _discriminator_leaves(c: JaxParams, cfg: GeneratorConfig) -> None:
    c.image_stem(cfg)
    c.dense("fc_bbox", "fc_bbox")
    c.put("emb_label.weight", c.take("emb_label"))
    c.bert_encoder("text_encoder/bert", "text_encoder", cfg.bert_num_encoder_layers,
                   cfg.encoder_bert_config().encoder_width)
    c.put("enc_text_len.weight", c.take("enc_text_len"))
    c.mlp("enc_fc_in", "enc_fc_in")
    c.transformer("enc_transformer", "enc_transformer", cfg.num_encoder_layers,
                  cfg.num_decoder_layers)
    c.dense("fc_out_disc", "fc_out_disc")
    c.dense("fc_bbox_uncond", "fc_bbox_uncond")
    c.put("emb_label_uncond.weight", c.take("emb_label_uncond"))
    c.mlp("enc_fc_in_uncond", "enc_fc_in_uncond")
    c.put("enc_transformer_uncond.token", c.take("enc_transformer_uncond/token"))
    for i in range(cfg.uncond_encoder_layers):
        c.torch_encoder_layer(f"enc_transformer_uncond/layers_{i}",
                              f"enc_transformer_uncond.core.layers.{i}")
    c.dense("fc_out_disc_uncond", "fc_out_disc_uncond")
    c.reconst_decoder("dec_transformer", "dec_fc_in", "pos_token", "dec_transformer",
                      cfg.reconst_decoder_layers)
    for name in ("bbox_embed", "fc_out_cls", "fc_text_len_rec"):
        c.dense(name, name)
    c.bert_lm_head("text_decoder", "text_decoder", cfg.bert_num_decoder_layers,
                   cfg.decoder_bert_config().encoder_width)
    c.stylegan2_decoder("bg_decoder", "bg_decoder", _decoder_resolutions(cfg.background_size))
    c.reconst_decoder("dec_transformer_uncond", "dec_fc_in_uncond", "pos_token_uncond",
                      "dec_transformer_uncond", cfg.reconst_decoder_layers)
    for name in ("bbox_embed_uncond", "fc_out_cls_uncond"):
        c.dense(name, name)


def _adam_state(opt_state) -> dict:
    """optax's Adam state, ``{"count", "mu", "nu"}``, inside an optimizer
    state as an orbax restore without a target gives it (dicts and lists):
    the 'train' branch of a ``multi_transform``, or a bare ``adam``."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if {"count", "mu", "nu"} <= set(node):
                found.append(node)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the optimizer state, "
                         f"found {len(found)}")
    return found[0]


def _fill_masked(moments, params, path=""):
    """``moments`` with each masked leaf (None: a frozen parameter, which
    ``set_to_zero`` keeps no moment for) as zeros of its weight's shape."""
    if isinstance(params, dict):
        moments = {} if moments is None else moments
        extra = set(moments) - set(params)
        if extra:
            raise KeyError(f"optimizer moments hold {sorted(extra)} under {path or '/'}, "
                           "which the weights lack")
        return {k: _fill_masked(moments.get(k), v, f"{path}/{k}") for k, v in params.items()}
    if moments is None:
        return np.zeros(np.shape(params), np.float32)
    if np.shape(moments) != np.shape(params):
        raise ValueError(f"moment {path}: shape {np.shape(moments)}, weight {np.shape(params)}")
    return moments


def _converted(tree: dict, cfg: GeneratorConfig, leaves) -> JaxParams:
    c = JaxParams(tree)
    leaves(c, cfg)
    c.finish()
    return c


def _adam_state_dict(opt_state, params: dict, cfg: GeneratorConfig, leaves, names: Sequence[str],
                     param_groups: list) -> dict:
    """optax's Adam moments -> a ``torch.optim.Adam`` state dict over
    ``names`` (the port optimizer's parameters, in its order)."""
    adam = _adam_state(opt_state)
    mu, nu = (_converted(_fill_masked(adam[k], params), cfg, leaves) for k in ("mu", "nu"))
    count = float(np.asarray(adam["count"]))
    state = {i: {"step": torch.tensor(count), "exp_avg": mu.sd[name], "exp_avg_sq": nu.sd[name]}
             for i, name in enumerate(names) if name not in mu.filled}
    return {"state": state, "param_groups": param_groups}


def snapshot_from_jax(state: dict, cfg: GeneratorConfig, glr: float = 1e-5, dlr: float = 1e-5,
                      g_reg_interval: Optional[int] = 4, d_reg_interval: Optional[int] = 16) -> dict:
    """A JAX ``GANTrainState`` (``params_g``, ``params_d``, ``params_gema``,
    ``opt_state_g``, ``opt_state_d``, ``pl_mean``, ``step``; nested dicts
    and lists of numpy arrays) -> the port's training snapshot dict, which
    ``utils.checkpoint.restore_checkpoint`` loads strictly into a state
    built for ``cfg``. The learning rates and reg intervals set the Adam
    hyperparameters the snapshot carries, as ``build_optimizer`` derives
    them (the JAX trainer's defaults unless given)."""
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.parallel.tensor_parallel import trainable_names
    from layoutdetr_tpu_torch.training.optimizers import build_optimizer

    snap = dict(G=generator_state_dict_from_jax(state["params_g"], cfg),
                D=discriminator_state_dict_from_jax(state["params_d"], cfg),
                G_ema=generator_state_dict_from_jax(state["params_gema"], cfg),
                step=int(np.asarray(state["step"])),
                pl_mean=torch.tensor(np.asarray(state["pl_mean"], np.float32)))
    for key, model, leaves, lr, interval in (
            ("g", Generator, _generator_leaves, glr, g_reg_interval),
            ("d", Discriminator, _discriminator_leaves, dlr, d_reg_interval)):
        with torch.device("meta"):  # the parameter names and order, without weights
            module = model(cfg)
        groups = build_optimizer(module, lr=lr, reg_interval=interval).state_dict()["param_groups"]
        snap[f"opt_{key}"] = _adam_state_dict(state[f"opt_state_{key}"], state[f"params_{key}"], cfg,
                                             leaves, trainable_names(module), groups)
    return snap


def layoutganpp_generator_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutGanPPGenerator`` params -> port ``LayoutGanPPGenerator``
    state dict for ``cfg`` (a ``LayoutGanPPConfig``)."""
    c = JaxParams(params)
    c.dense("fc_z", "fc_z")
    c.bert_encoder("text_encoder/bert", "text_encoder", cfg.bert_num_encoder_layers,
                   cfg.encoder_bert_config().encoder_width)
    c.stylegan2_encoder("bg_encoder", "bg_encoder", cfg.background_size)
    c.dense("fc_in", "fc_in")
    for i in range(cfg.num_layers):
        c.torch_encoder_layer(f"transformer_layers_{i}", f"transformer_layers.{i}")
    c.dense("fc_out", "fc_out")
    return c.finish()


def layoutganpp_discriminator_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutGanPPDiscriminator`` params, initialised with
    ``reconst=True`` (the reconstruction heads included) -> port
    ``LayoutGanPPDiscriminator`` state dict for ``cfg``."""
    c = JaxParams(params)
    c.dense("fc_bbox", "fc_bbox")
    c.bert_encoder("text_encoder/bert", "text_encoder", cfg.bert_num_encoder_layers,
                   cfg.encoder_bert_config().encoder_width)
    c.stylegan2_encoder("bg_encoder", "bg_encoder", cfg.background_size)
    c.dense("enc_fc_in", "enc_fc_in")
    c.put("enc_transformer.token", c.take("enc_transformer/token"))
    for i in range(cfg.num_layers):
        c.torch_encoder_layer(f"enc_transformer/layers_{i}", f"enc_transformer.core.layers.{i}")
    c.dense("fc_out_disc", "fc_out_disc")
    c.put("pos_token", c.take("pos_token"))
    c.dense("dec_fc_in", "dec_fc_in")
    for i in range(cfg.num_layers):
        c.torch_encoder_layer(f"dec_layers_{i}", f"dec_layers.{i}")
    c.dense("fc_out_bbox", "fc_out_bbox")
    c.bert_lm_head("text_decoder", "text_decoder", cfg.bert_num_decoder_layers,
                   cfg.decoder_bert_config().encoder_width)
    c.stylegan2_decoder("bg_decoder", "bg_decoder", _decoder_resolutions(cfg.background_size))
    return c.finish()


def layoutnet_state_dict_from_jax(params: dict, num_layers: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutNet`` params -> port ``LayoutNet`` state dict, under the
    reference's names: ``emb_label_table`` -> ``emb_label.weight``,
    ``pos_token`` [50, D] -> [50, 1, D], ``enc_transformer/layers_{i}`` ->
    ``enc_transformer.core.layers.{i}``, ``dec_layers_{i}`` ->
    ``dec_transformer.layers.{i}``."""
    c = JaxParams(params)
    c.put("emb_label.weight", c.take("emb_label_table"))
    c.put("pos_token", c.take("pos_token")[:, None, :])
    for name in ("fc_bbox", "enc_fc_in", "fc_out_disc", "dec_fc_in", "fc_out_cls", "fc_out_bbox"):
        c.dense(name, name)
    c.put("enc_transformer.token", c.take("enc_transformer/token"))
    for i in range(num_layers):
        c.torch_encoder_layer(f"enc_transformer/layers_{i}", f"enc_transformer.core.layers.{i}")
        c.torch_encoder_layer(f"dec_layers_{i}", f"dec_transformer.layers.{i}")
    return c.finish()


def inception_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3`` params -> port ``InceptionV3`` state dict in
    pytorch-fid naming: each ``BasicConv2d`` ``<block>[/<branch>]`` with
    ``conv`` (HWIO) and ``bn_weight``/``bn_bias``/``bn_mean``/``bn_var``
    becomes ``<block>[.<branch>].conv.weight`` (OIHW) and
    ``.bn.weight/bias/running_mean/running_var``."""
    c = JaxParams(params)
    for src in sorted({path.rsplit("/", 1)[0] for path in c.flat}):
        dst = src.replace("/", ".")
        c.conv(src, f"{dst}.conv", leaf="conv")
        for jax_leaf, leaf in (("bn_weight", "weight"), ("bn_bias", "bias"),
                               ("bn_mean", "running_mean"), ("bn_var", "running_var")):
            c.put(f"{dst}.bn.{leaf}", c.take(f"{src}/{jax_leaf}"))
    return c.finish()
