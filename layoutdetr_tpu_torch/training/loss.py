"""GAN loss terms of the LayoutDETR train step.

Counterpart of ``layoutdetr_tpu/training/loss.py`` (reference
training/loss.py:28-218, StyleGAN2Loss): ``LossWeights``, ``g_main_loss``
(Gmain) and ``d_main_loss`` (Dmain = Dgen + Dreal), with the same terms,
default weights and softplus objectives. They take the port's modules
and return (total, stats); the train step differentiates the total with
respect to the phase's own parameters only, so in Gmain D's parameters
get no gradient, and in Dmain G runs under ``torch.no_grad`` (JAX's
``stop_gradient``).

Dropout: every forward draws its own masks, as ``_fold_rngs`` gives each
JAX forward its own stream. The loss functions take a CPU
``torch.Generator`` and derive from it, on the host, one device
generator per forward (``fork_generator``). ``batch["mask"]`` is True
for valid elements. ``g_pl_loss``, ``d_r1_loss`` and the ADA augmentation
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from layoutdetr_tpu_torch.metrics.layout_metrics import (
    compute_alignment,
    compute_overlap,
    generalized_iou_loss,
    masked_cross_entropy,
    masked_mse,
)


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Defaults mirror training/loss.py:30-32 (as resolved by train.py:262-275)."""

    Dreal_bbox_cls_weight: float = 50.0
    Dreal_bbox_rec_weight: float = 500.0
    Dreal_text_rec_weight: float = 0.1
    Dreal_text_len_rec_weight: float = 2.0
    Dreal_im_rec_weight: float = 0.5
    Ggen_bbox_rec_weight: float = 100.0
    Ggen_bbox_gIoU_weight: float = 4.0
    Ggen_overlapping_weight: float = 7.0
    Ggen_alignment_weight: float = 17.0
    Ggen_z_rec_weight: float = 5.0
    Ggen_bbox_cls_weight: float = 50.0
    Ggen_text_rec_weight: float = 1.0
    Ggen_text_len_rec_weight: float = 1.0
    pl_weight: float = 0.0
    r1_gamma: float = 0.0


def fork_generator(generator: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """A fresh generator on ``device`` seeded by a host draw from
    ``generator`` (None stays None): an independent stream per forward,
    with no device sync."""
    if generator is None:
        return None
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def _model_inputs(batch: Dict[str, torch.Tensor], text_feat_key: Optional[str] = None) -> dict:
    """Model kwargs from a batch; ``text_feat_key`` ("text_feat_g" /
    "text_feat_d") selects the hoisted frozen-text-encoder features."""
    out = dict(bbox_class=batch["labels"], text_ids=batch["text_ids"],
               text_mask=batch["text_mask"], text_len=batch["text_len"],
               padding_mask=~batch["mask"], background=batch["background"])
    if text_feat_key is not None and text_feat_key in batch:
        out["text_feat"] = batch[text_feat_key]
    return out


def g_main_loss(G, D, batch, z, w: LossWeights, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, dict]:
    """Gmain phase (loss.py:84-116): adversarial + reconstruction terms."""
    dev = z.device
    gen_g = None if deterministic else fork_generator(generator, dev)
    gen_d = None if deterministic else fork_generator(generator, dev)
    valid = batch["mask"]
    bbox_fake, loss_z, logit_cls, loss_lm, loss_text_len = G(
        z, bbox_real=batch["bboxes"], reconst=True, deterministic=deterministic,
        generator=gen_g, **_model_inputs(batch, "text_feat_g"))
    gen_logits, gen_logits_uncond = D(bbox_fake, deterministic=deterministic, generator=gen_d,
                                      **_model_inputs(batch, "text_feat_d"))

    loss_Ggen = F.softplus(-gen_logits).mean()
    loss_Ggen_uncond = F.softplus(-gen_logits_uncond).mean()
    loss_bbox_rec = masked_mse(bbox_fake, batch["bboxes"], valid) * w.Ggen_bbox_rec_weight
    loss_giou = generalized_iou_loss(bbox_fake, batch["bboxes"], valid) * w.Ggen_bbox_gIoU_weight
    loss_overlap = compute_overlap(bbox_fake, valid).mean() * w.Ggen_overlapping_weight
    loss_align = compute_alignment(bbox_fake, valid).mean() * w.Ggen_alignment_weight
    loss_z_rec = loss_z * w.Ggen_z_rec_weight
    loss_cls = masked_cross_entropy(logit_cls, batch["labels"], valid) * w.Ggen_bbox_cls_weight
    loss_text = loss_lm * w.Ggen_text_rec_weight
    loss_tlen = loss_text_len * w.Ggen_text_len_rec_weight

    total = (loss_Ggen + loss_Ggen_uncond + loss_bbox_rec + loss_giou + loss_overlap
             + loss_align + loss_z_rec + loss_cls + loss_text + loss_tlen)
    stats = {
        "Loss/scores/fake": gen_logits.mean(),
        "Loss/signs/fake": torch.sign(gen_logits).mean(),
        "Loss/G/loss_Ggen": loss_Ggen,
        "Loss/G/loss_Ggen_uncond": loss_Ggen_uncond,
        "Loss/G/loss_Ggen_bbox_rec": loss_bbox_rec,
        "Loss/G/loss_Ggen_bbox_gIoU": loss_giou,
        "Loss/G/loss_Ggen_overlapping": loss_overlap,
        "Loss/G/loss_Ggen_alignment": loss_align,
        "Loss/G/loss_Ggen_z_rec": loss_z_rec,
        "Loss/G/loss_Ggen_bbox_cls": loss_cls,
        "Loss/G/loss_Ggen_text_rec": loss_text,
        "Loss/G/loss_Ggen_text_len_rec": loss_tlen,
    }
    return total, stats


def d_main_loss(G, D, batch, z, w: LossWeights, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, dict]:
    """Dmain phase = Dgen (loss.py:146-157) + Dreal (loss.py:161-206)."""
    dev = z.device
    gen_g, gen_dfake, gen_dreal = (None if deterministic else fork_generator(generator, dev)
                                   for _ in range(3))
    valid = batch["mask"]
    with torch.no_grad():  # Dgen: fakes from a frozen G
        bbox_fake = G(z, bbox_real=batch["bboxes"], reconst=False, deterministic=deterministic,
                      generator=gen_g, **_model_inputs(batch, "text_feat_g"))
    d_inputs = _model_inputs(batch, "text_feat_d")
    gen_logits, gen_logits_uncond = D(bbox_fake, deterministic=deterministic,
                                      generator=gen_dfake, **d_inputs)
    loss_Dgen = F.softplus(gen_logits).mean()
    loss_Dgen_uncond = F.softplus(gen_logits_uncond).mean()

    (real_logits, real_logits_uncond, bbox_rec, bbox_cls_logits, loss_lm, loss_text_len, bg_rec,
     bbox_rec_uncond, bbox_cls_logits_uncond) = D(
        batch["bboxes"], reconst=True, deterministic=deterministic, generator=gen_dreal,
        **d_inputs)
    loss_Dreal = F.softplus(-real_logits).mean()
    loss_Dreal_uncond = F.softplus(-real_logits_uncond).mean()
    loss_bbox_rec = masked_mse(bbox_rec, batch["bboxes"], valid) * w.Dreal_bbox_rec_weight
    loss_cls = masked_cross_entropy(bbox_cls_logits, batch["labels"], valid) * w.Dreal_bbox_cls_weight
    loss_text = loss_lm * w.Dreal_text_rec_weight
    loss_tlen = loss_text_len * w.Dreal_text_len_rec_weight
    loss_bg = ((bg_rec - batch["background"]) ** 2).mean() * w.Dreal_im_rec_weight
    loss_bbox_rec_u = masked_mse(bbox_rec_uncond, batch["bboxes"], valid) * w.Dreal_bbox_rec_weight
    loss_cls_u = (masked_cross_entropy(bbox_cls_logits_uncond, batch["labels"], valid)
                  * w.Dreal_bbox_cls_weight)

    total = (loss_Dgen + loss_Dgen_uncond + loss_Dreal + loss_Dreal_uncond + loss_bbox_rec
             + loss_cls + loss_text + loss_tlen + loss_bg + loss_bbox_rec_u + loss_cls_u)
    stats = {
        "Loss/scores/fake_D": gen_logits.mean(),
        "Loss/scores/real": real_logits.mean(),
        "Loss/signs/real": torch.sign(real_logits).mean(),
        "Loss/D/loss_Dgen": loss_Dgen,
        "Loss/D/loss_Dgen_uncond": loss_Dgen_uncond,
        "Loss/D/loss_Dreal": loss_Dreal,
        "Loss/D/loss_Dreal_uncond": loss_Dreal_uncond,
        "Loss/D/loss_Dreal_bbox_rec": loss_bbox_rec,
        "Loss/D/loss_Dreal_bbox_cls": loss_cls,
        "Loss/D/loss_Dreal_text_rec": loss_text,
        "Loss/D/loss_Dreal_text_len_rec": loss_tlen,
        "Loss/D/loss_Dreal_bg_rec": loss_bg,
        "Loss/D/loss_Dreal_bbox_rec_uncond": loss_bbox_rec_u,
        "Loss/D/loss_Dreal_bbox_cls_uncond": loss_cls_u,
    }
    return total, stats
