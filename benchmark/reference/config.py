"""Model configurations of the port.

Counterparts of ``GeneratorConfig`` (layoutdetr_tpu/models/generator.py)
and ``BertConfig`` (layoutdetr_tpu/models/bert.py), with the same names
and defaults for every field the port reads. ``from_dict`` drops the
keys of a JAX-written config that the port has no use for (``remat``,
which the port does not need at batch 16 on an 80 GB card), so such a
config reads here. The JAX-only ``flash_interpret`` is gone: here the
choice between the attention kernel and its plain version follows the
tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The med_config.json fields the models consume."""

    vocab_size: int = 30524  # 30522 + [DEC] + [ENC]
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1  # embeddings, attention output, FFN output
    attention_probs_dropout_prob: float = 0.1
    # Width of the states cross-attention reads (its key/value inputs).
    encoder_width: int = 768
    # Every layer holds cross-attention parameters (the reference's MED
    # BERT); mode='text' never runs them.
    add_cross_attention: bool = True
    # Self-attention with a key-only mask goes through the fused kernel
    # (ops/attention.py) when no gradient is recorded.
    flash_attention: bool = False


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 4
    num_bbox_labels: int = 8
    max_elements: int = 9
    hidden_dim: int = 256
    bert_f_dim: int = 768
    bert_num_heads: int = 4
    bert_num_encoder_layers: int = 12
    bert_num_decoder_layers: int = 2  # the text decoder of G's and D's reconstruction heads
    im_f_dim: int = 512  # w_dim and channel_max of D's bg_decoder
    max_text_length: int = 256
    # Size of the character-length embedding table. None ties it to
    # max_text_length (the reference's table size); an explicit value
    # lets the token dimension T shrink (--max-text-length auto) without
    # changing the length embedding.
    text_len_table: Optional[int] = None
    vocab_size: int = 30524
    bos_token_id: int = 30522  # [DEC], first token of the text decoder's input
    pad_token_id: int = 0  # ignored by the LM loss
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    # D's reconstruction decoders and unconditional critic (6 in the
    # reference; tiny test configs shrink them).
    reconst_decoder_layers: int = 6
    uncond_encoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1  # the DETR transformers'
    background_size: int = 256
    backbone: str = "resnet50"
    # ResNet stage depths; tiny test configs shrink them.
    backbone_stage_sizes: tuple = (3, 4, 6, 3)
    bert_intermediate_size: int = 3072
    bert_max_position_embeddings: int = 512

    def __post_init__(self):
        object.__setattr__(self, "backbone_stage_sizes", tuple(self.backbone_stage_sizes))
        if self.text_len_table is None:
            object.__setattr__(self, "text_len_table", self.max_text_length)

    def encoder_bert_config(self, flash_attention: bool = True) -> BertConfig:
        """The text encoder's BERT. It is frozen, so the port runs its
        self-attention through the fused kernel by default."""
        return BertConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.bert_f_dim,
            intermediate_size=self.bert_intermediate_size,
            max_position_embeddings=self.bert_max_position_embeddings,
            num_hidden_layers=self.bert_num_encoder_layers,
            num_attention_heads=self.bert_num_heads,
            encoder_width=self.bert_f_dim,
            flash_attention=flash_attention,
        )

    def decoder_bert_config(self) -> BertConfig:
        """The text decoder's BERT (causal, plain attention)."""
        return BertConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.bert_f_dim,
            intermediate_size=self.bert_intermediate_size,
            max_position_embeddings=self.bert_max_position_embeddings,
            num_hidden_layers=self.bert_num_decoder_layers,
            num_attention_heads=self.bert_num_heads,
            encoder_width=self.im_f_dim,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GeneratorConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
