"""LayoutNet: the (bbox, label) feature network behind the layout FID.

Counterpart of ``layoutdetr_tpu/models/layoutnet.py:39-95`` (reference
training/networks_layoutnet.py:17-86): a 4-layer transformer with a CLS
token over per-element (bbox, label) pairs, d=256, 4 heads, FFN d/2, at
most 50 boxes. ``extract_features`` returns the CLS output; the forward
adds the discriminator, classifier and bbox heads of the LayoutGAN++
metric net.

The state dict has the reference's names and shapes, so a reference
``layoutnet_<dataset>.pth.tar`` loads strictly: ``emb_label.weight``,
``pos_token`` [50, 1, d], ``enc_transformer.token`` [1, 1, d],
``enc_transformer.core.layers.{i}.*``, ``dec_transformer.layers.{i}.*``
and the ``fc_*`` Linear layers.

The reference's label remappings for the ads and CGL datasets
(networks_layoutnet.py:51-61) are lookup tables, labels clipped into them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.models.detr_transformer import (
    TorchEncoderLayer,
    TransformerWithTokenEncoder,
    _Stack,
)
from layoutdetr_tpu_torch.models.layers import Dense, padding_bias

# label_idx_replace (ads datasets): {header, pre-header, post-header, body
# text, disclaimer} -> TEXT(2), button -> BUTTON(4), logo -> PICTOGRAM(3),
# callout -> ADVERTISEMENT(7).
ADS_REMAP = (2, 2, 2, 2, 2, 4, 7, 3, 8, 9, 10, 11, 12)
# label_idx_replace_2 (CGL): Logo->3, Text->2, Underlay->4, Embellishment->3,
# Highlighted text->2.
CGL_REMAP = (3, 2, 4, 3, 2, 5, 6, 7, 8, 9, 10, 11, 12)


def remap_labels(label: torch.Tensor, label_idx_replace: bool = False,
                 label_idx_replace_2: bool = False) -> torch.Tensor:
    for on, table in ((label_idx_replace, ADS_REMAP), (label_idx_replace_2, CGL_REMAP)):
        if on:
            lut = torch.tensor(table, dtype=label.dtype, device=label.device)
            return lut[label.clamp(0, len(table) - 1)]
    return label


class LayoutNet(nn.Module):
    def __init__(self, num_label: int, d_model: int = 256, nhead: int = 4, num_layers: int = 4,
                 max_bbox: int = 50):
        super().__init__()
        self.num_label = num_label
        self.emb_label = nn.Embedding(num_label, d_model)
        self.pos_token = nn.Parameter(torch.rand(max_bbox, 1, d_model))
        self.fc_bbox = Dense(4, d_model)
        self.enc_fc_in = Dense(d_model * 2, d_model)
        self.enc_transformer = TransformerWithTokenEncoder(d_model, nhead, d_model // 2, num_layers)
        self.fc_out_disc = Dense(d_model, 1)
        self.dec_fc_in = Dense(d_model * 2, d_model)
        self.dec_transformer = _Stack(TorchEncoderLayer(d_model, nhead, d_model // 2)
                                      for _ in range(num_layers))
        self.fc_out_cls = Dense(d_model, num_label)
        self.fc_out_bbox = Dense(d_model, 4)

    def extract_features(self, bbox, label, padding_mask, label_idx_replace: bool = False,
                         label_idx_replace_2: bool = False):
        """bbox [B, N, 4], label [B, N] int, padding_mask [B, N] True=padded
        -> [B, d] CLS features."""
        label = remap_labels(label, label_idx_replace, label_idx_replace_2)
        x = torch.cat([self.fc_bbox(bbox.float()), self.emb_label(label)], dim=-1)
        x = self.enc_transformer(F.relu(self.enc_fc_in(x)), padding_mask)
        return x[:, 0]

    def forward(self, bbox, label, padding_mask):
        """-> (logit_disc [B], logit_cls [B, N, num_label], bbox_pred [B, N, 4])."""
        b, n = label.shape
        x0 = self.extract_features(bbox, label, padding_mask)
        logit_disc = self.fc_out_disc(x0)[..., 0]
        x = x0[:, None, :].expand(b, n, x0.shape[-1])
        t = self.pos_token[:n, 0][None].expand(b, n, x0.shape[-1])
        x = F.relu(self.dec_fc_in(torch.cat([x, t], dim=-1)))
        bias = padding_bias(padding_mask)
        for layer in self.dec_transformer.layers:
            x = layer(x, bias)
        return logit_disc, self.fc_out_cls(x), torch.sigmoid(self.fc_out_bbox(x))
