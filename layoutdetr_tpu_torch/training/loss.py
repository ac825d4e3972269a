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
for valid elements.

ADA: when ``batch["aug_p"]`` (a float) is present, every input of D's
critic in Gmain and Dmain is augmented with draws of its own from the
host generator (``_augmented``); the reconstruction target stays the
clean background.

The lazy regularizers: ``g_pl_loss`` (path-length penalty on the
z -> bbox Jacobian, a double backward through G) and ``d_r1_loss`` (the
gradient penalty on D's logits w.r.t. the bbox input, a double backward
through D's critics at ``reconst=False``, which never reach ``bias_act``).

Data parallelism (``parallel.distributed``): JAX's SPMD step divides each
masked mean by the global batch's count of valid entries, and a rank
holds a share of that batch with counts of its own. ``_dp_shares``
scales this rank's masked means (the elements' and the text tokens') so
that the ranks' average of the losses, and of their gradients, is the
global mean; the plain ``.mean()`` terms are over equal shares and stay.
The path-length running mean moves by the mean over every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from layoutdetr_tpu_torch.metrics.layout_metrics import (
    compute_alignment,
    compute_overlap,
    generalized_iou_loss,
    masked_cross_entropy,
    masked_mse,
)
from layoutdetr_tpu_torch.models.generator import text_reconstruction_tokens
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.training.augment import (
    CONDITIONAL_SAFE,
    AugmentConfig,
    apply_augment,
    draw_augment_params,
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


def _augmented(inputs: dict, batch: dict, generator: Optional[torch.Generator],
               aug_cfg: Optional[AugmentConfig] = None) -> dict:
    """``inputs`` with the background ADA-augmented at ``batch["aug_p"]``,
    drawn from the host ``generator`` (loss.py:82-102); as they are without
    ``aug_p`` or a generator. ``aug_cfg`` defaults to CONDITIONAL_SAFE."""
    if "aug_p" not in batch or generator is None:
        return inputs
    cfg = CONDITIONAL_SAFE if aug_cfg is None else aug_cfg
    bg = inputs["background"]
    params = draw_augment_params(bg.shape[0], batch["aug_p"], generator, cfg)
    return dict(inputs, background=apply_augment(bg, params, cfg))


def _dp_shares(batch: dict, pad_token_id: int):
    """(elements, tokens): the factors of this rank's masked means over the
    valid elements and over the text decoder's target tokens that make
    their average over the data ranks the global batch's means
    (``distributed.global_shares``); 1.0 and 1.0 in a process alone."""
    if distributed.grid() is None:
        return 1.0, 1.0
    valid = batch["mask"]
    counts = torch.stack([valid.sum(), text_reconstruction_tokens(batch["text_ids"], valid,
                                                                  pad_token_id)])
    elements, tokens = distributed.global_shares(counts.float())
    return elements, tokens


def g_main_loss(G, D, batch, z, w: LossWeights, deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                aug_cfg: Optional[AugmentConfig] = None) -> Tuple[torch.Tensor, dict]:
    """Gmain phase (loss.py:84-116): adversarial + reconstruction terms."""
    dev = z.device
    gen_g = None if deterministic else fork_generator(generator, dev)
    gen_d = None if deterministic else fork_generator(generator, dev)
    valid = batch["mask"]
    share, token_share = _dp_shares(batch, G.cfg.pad_token_id)
    bbox_fake, loss_z, logit_cls, loss_lm, loss_text_len = G(
        z, bbox_real=batch["bboxes"], reconst=True, deterministic=deterministic,
        generator=gen_g, **_model_inputs(batch, "text_feat_g"))
    d_inputs = _augmented(_model_inputs(batch, "text_feat_d"), batch, generator, aug_cfg)
    gen_logits, gen_logits_uncond = D(bbox_fake, deterministic=deterministic, generator=gen_d,
                                      **d_inputs)

    loss_Ggen = F.softplus(-gen_logits).mean()
    loss_Ggen_uncond = F.softplus(-gen_logits_uncond).mean()
    loss_bbox_rec = (masked_mse(bbox_fake, batch["bboxes"], valid)
                     * (w.Ggen_bbox_rec_weight * share))
    loss_giou = (generalized_iou_loss(bbox_fake, batch["bboxes"], valid)
                 * (w.Ggen_bbox_gIoU_weight * share))
    loss_overlap = compute_overlap(bbox_fake, valid).mean() * w.Ggen_overlapping_weight
    loss_align = compute_alignment(bbox_fake, valid).mean() * w.Ggen_alignment_weight
    loss_z_rec = loss_z * (w.Ggen_z_rec_weight * share)
    loss_cls = (masked_cross_entropy(logit_cls, batch["labels"], valid)
                * (w.Ggen_bbox_cls_weight * share))
    loss_text = loss_lm * (w.Ggen_text_rec_weight * token_share)
    loss_tlen = loss_text_len * (w.Ggen_text_len_rec_weight * share)

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
                generator: Optional[torch.Generator] = None,
                aug_cfg: Optional[AugmentConfig] = None) -> Tuple[torch.Tensor, dict]:
    """Dmain phase = Dgen (loss.py:146-157) + Dreal (loss.py:161-206)."""
    dev = z.device
    gen_g, gen_dfake, gen_dreal = (None if deterministic else fork_generator(generator, dev)
                                   for _ in range(3))
    valid = batch["mask"]
    share, token_share = _dp_shares(batch, D.cfg.pad_token_id)
    with torch.no_grad():  # Dgen: fakes from a frozen G
        bbox_fake = G(z, bbox_real=batch["bboxes"], reconst=False, deterministic=deterministic,
                      generator=gen_g, **_model_inputs(batch, "text_feat_g"))
    d_inputs = _model_inputs(batch, "text_feat_d")
    gen_logits, gen_logits_uncond = D(bbox_fake, deterministic=deterministic, generator=gen_dfake,
                                      **_augmented(d_inputs, batch, generator, aug_cfg))
    loss_Dgen = F.softplus(gen_logits).mean()
    loss_Dgen_uncond = F.softplus(gen_logits_uncond).mean()

    # the critic's input is augmented; the reconstruction target stays the
    # clean background (loss.py:185-187)
    (real_logits, real_logits_uncond, bbox_rec, bbox_cls_logits, loss_lm, loss_text_len, bg_rec,
     bbox_rec_uncond, bbox_cls_logits_uncond) = D(
        batch["bboxes"], reconst=True, deterministic=deterministic, generator=gen_dreal,
        **_augmented(d_inputs, batch, generator, aug_cfg))
    loss_Dreal = F.softplus(-real_logits).mean()
    loss_Dreal_uncond = F.softplus(-real_logits_uncond).mean()
    loss_bbox_rec = (masked_mse(bbox_rec, batch["bboxes"], valid)
                     * (w.Dreal_bbox_rec_weight * share))
    loss_cls = (masked_cross_entropy(bbox_cls_logits, batch["labels"], valid)
                * (w.Dreal_bbox_cls_weight * share))
    loss_text = loss_lm * (w.Dreal_text_rec_weight * token_share)
    loss_tlen = loss_text_len * (w.Dreal_text_len_rec_weight * share)
    loss_bg = ((bg_rec - batch["background"]) ** 2).mean() * w.Dreal_im_rec_weight
    loss_bbox_rec_u = (masked_mse(bbox_rec_uncond, batch["bboxes"], valid)
                       * (w.Dreal_bbox_rec_weight * share))
    loss_cls_u = (masked_cross_entropy(bbox_cls_logits_uncond, batch["labels"], valid)
                  * (w.Dreal_bbox_cls_weight * share))

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


def g_pl_loss(G, batch, w: LossWeights, pl_mean: torch.Tensor, z: Optional[torch.Tensor] = None,
              pl_noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              text_feature_fn: Optional[Callable] = None, pl_decay: float = 0.01,
              pl_batch_shrink: int = 2) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Gpl, the path-length penalty on the z -> bbox Jacobian (loss.py:225-250;
    reference loss.py:119-142), on the first b / ``pl_batch_shrink``
    samples (of this rank's batch: the reference's per-rank shrink, where
    JAX's SPMD takes the global batch's first half), deterministic; the
    running mean moves by the lengths' mean over all ranks.
    ``z`` ([>= shrink, N, z_dim]) and ``pl_noise``
    (standard normal, [shrink, N, 4]) are drawn from ``generator`` when not
    given. ``text_feature_fn`` (``make_text_feature_fn`` of G's frozen
    encoder) computes the shrunk batch's text features once, without
    gradients; without it G's own encoder runs in the forward. Returns
    (loss, new pl_mean (detached), stats); the loss keeps its graph to G's
    parameters."""
    b = batch["labels"].shape[0]
    shrink = max(b // pl_batch_shrink, 1)
    dev = batch["labels"].device
    inputs = {k: v[:shrink] for k, v in _model_inputs(batch).items()}
    if text_feature_fn is not None:
        inputs["text_feat"] = text_feature_fn(inputs["text_ids"], inputs["text_mask"])
    n = batch["labels"].shape[1]
    if z is None:
        z = torch.randn(shrink, n, G.cfg.z_dim, device=dev, generator=fork_generator(generator, dev))
    z_s = z[:shrink].detach().requires_grad_(True)
    bbox_fake = G(z_s, bbox_real=batch["bboxes"][:shrink], reconst=False, deterministic=True,
                  **inputs)
    if pl_noise is None:
        pl_noise = torch.randn(bbox_fake.shape, device=dev, generator=fork_generator(generator, dev))
    pl_noise = pl_noise / bbox_fake.shape[2]
    (pl_grads,) = torch.autograd.grad((bbox_fake * pl_noise).sum(), z_s, create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=(1, 2)).sqrt()
    # the mean over every rank's samples, so pl_mean stays one value
    new_pl_mean = pl_mean + pl_decay * (distributed.data_mean(pl_lengths.mean()) - pl_mean)
    pl_penalty = (pl_lengths - new_pl_mean).square()
    loss = (pl_penalty * w.pl_weight).mean()
    return loss, new_pl_mean.detach(), {"Loss/pl_penalty": pl_penalty.mean().detach(),
                                        "Loss/G/reg": loss.detach()}


def d_r1_loss(D, batch, w: LossWeights,
              text_feature_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, dict]:
    """Dr1, the gradient penalty on D's logits w.r.t. the bbox input
    (loss.py:253-267; reference loss.py:209-215), deterministic, at
    ``reconst=False``. ``text_feature_fn`` (``make_text_feature_fn`` of D's
    frozen encoder) computes the text features once, without gradients;
    without it D's own encoder runs in the forward. The loss keeps its
    graph to D's parameters."""
    inputs = _model_inputs(batch)
    if text_feature_fn is not None:
        inputs["text_feat"] = text_feature_fn(inputs["text_ids"], inputs["text_mask"])
    bbox = batch["bboxes"].detach().requires_grad_(True)
    logits, _ = D(bbox, deterministic=True, **inputs)
    (r1_grads,) = torch.autograd.grad(logits.sum(), bbox, create_graph=True)
    r1_penalty = r1_grads.square().sum(dim=(1, 2))
    loss = (r1_penalty * (w.r1_gamma / 2)).mean()
    return loss, {"Loss/r1_penalty": r1_penalty.mean().detach(), "Loss/D/reg": loss.detach()}
