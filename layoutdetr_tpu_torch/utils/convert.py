"""JAX param tree -> port state dict.

``generator_state_dict_from_jax`` takes the JAX Generator's parameters
(the ``params`` tree of ``Generator.init`` or of an orbax checkpoint, as
nested dicts of numpy arrays) and returns a ``state_dict`` that
``Generator.load_state_dict(..., strict=True)`` accepts. Conventions
converted (the inverse of the JAX package's torch converter):

- Dense kernel [in, out] -> Linear weight [out, in];
- conv kernel HWIO -> OIHW; ``input_proj`` Dense [2048, D] -> 1x1 conv
  [D, 2048, 1, 1];
- LayerNorm scale/bias -> weight/bias;
- attention in_proj_kernel [D, 3D] -> in_proj_weight [3D, D],
  out_kernel/out_bias -> out_proj.weight/bias.

Every leaf the layout path needs is consumed; a missing one raises, and
so does any leaf left over, except the subtrees that wait for the
training slice and are skipped here: the reconstruction heads
(``fc_z_rec``, ``fc_out_cls``, ``fc_text_len_rec``), the text decoder
(``text_decoder``) and the text encoder's ``crossattention`` blocks.

``JaxParams`` does the same for one submodule at a time.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig

SKIPPED_SUBTREES = ("fc_z_rec", "fc_out_cls", "fc_text_len_rec", "text_decoder")


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

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"JAX params lack {path!r}")
        return self.flat.pop(path)

    def put(self, name: str, arr: np.ndarray):
        self.sd[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def finish(self, skip=lambda path: False) -> Dict[str, torch.Tensor]:
        """The state dict; raises if a leaf not matched by ``skip`` is left."""
        extra = sorted(p for p in self.flat if not skip(tuple(p.split("/"))))
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

    def conv(self, src: str, dst: str):
        self.put(_dst(dst, "weight"), self.take(_src(src, "kernel")).transpose(3, 2, 0, 1))

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

    def bert_encoder(self, src: str, dst: str, num_layers: int):
        """JAX ``BertModel`` params -> port ``BertModel``/``TextEncoder``."""
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


def _generator_skip(path) -> bool:
    return path[0] in SKIPPED_SUBTREES or "crossattention" in path


def generator_state_dict_from_jax(params: dict, cfg: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params (with or without the top ``params`` key)
    -> port ``Generator`` state dict for ``cfg``."""
    c = JaxParams(params)
    c.resnet("backbone", "backbone.0.body", cfg.backbone_stage_sizes)
    c.put("input_proj.weight", c.take("input_proj/kernel").T[:, :, None, None])
    c.put("input_proj.bias", c.take("input_proj/bias"))
    c.dense("fc_z", "fc_z")
    c.put("emb_label.weight", c.take("emb_label"))
    c.put("enc_text_len.weight", c.take("enc_text_len"))
    c.mlp("fc_in", "fc_in")
    c.bert_encoder("text_encoder/bert", "text_encoder", cfg.bert_num_encoder_layers)
    c.transformer("transformer", "transformer", cfg.num_encoder_layers, cfg.num_decoder_layers)
    c.mlp("bbox_embed", "bbox_embed")
    return c.finish(_generator_skip)
