"""The CycleGAN loss suite, composed as the reference G/D steps
(ducosy_tpu/losses/suite.py; modules/trainer.py:462-525), in fp32.

generator_loss is the 9-term objective
  GAN + l_cyc*cycle + l_id*identity + l_grad*grad_cycle + l_grad_id*grad_id
  + l_ssim*(1 - SSIM) + l_ca*attention + l_cr*region + l_ce*edge,
where the contrast terms see only the NCCT -> CECT direction (fake_B vs
real_B vs real_A). discriminator_loss is the LSGAN real/fake average.
"""
from __future__ import annotations

from typing import NamedTuple

from ducosy_tpu_torch.config import LossConfig, TrainConfig
from ducosy_tpu_torch.losses import basic, contrast
from ducosy_tpu_torch.losses import ssim as ssim_mod


class LossTerms(NamedTuple):
    total: object
    gan: object
    cycle: object
    identity: object
    grad_cycle: object
    grad_id: object
    ssim: object
    contrast_attention: object
    contrast_region: object
    contrast_edge: object


def _squeeze(x):
    """NHW1 -> NHW, in fp32."""
    x = x.float()
    return x[..., 0] if x.dim() == 4 and x.shape[-1] == 1 else x


def _id_gan_cycle(real_a, real_b, rec_a, rec_b, id_a, id_b, d_a_fake_logits,
                  d_b_fake_logits, sw):
    loss_id = (basic.l1(id_a, real_a, sw) + basic.l1(id_b, real_b, sw)) / 2
    loss_gan = (basic.lsgan_real(d_b_fake_logits.float(), sw)
                + basic.lsgan_real(d_a_fake_logits.float(), sw)) / 2
    loss_cycle = (basic.l1(rec_a, real_a, sw) + basic.l1(rec_b, real_b, sw)) / 2
    return loss_id, loss_gan, loss_cycle


def generator_loss(*, real_a, real_b, fake_a, fake_b, rec_a, rec_b, id_a,
                   id_b, d_a_fake_logits, d_b_fake_logits, cfg: TrainConfig,
                   loss_cfg: LossConfig = LossConfig(), sample_weight=None,
                   n_real: int | None = None) -> LossTerms:
    """The 9 terms and their weighted total. Images are NHWC (image
    channel only) or (N, H, W); sample_weight (N,) 1/0 with n_real, the
    count of real samples, reproduce a ragged batch exactly."""
    sw = sample_weight
    real_a, real_b, fake_a, fake_b, rec_a, rec_b, id_a, id_b = map(
        _squeeze, (real_a, real_b, fake_a, fake_b, rec_a, rec_b, id_a, id_b))
    loss_id, loss_gan, loss_cycle = _id_gan_cycle(
        real_a, real_b, rec_a, rec_b, id_a, id_b, d_a_fake_logits,
        d_b_fake_logits, sw)
    loss_grad_cycle = (basic.gradient_loss(rec_a, real_a, sw)
                       + basic.gradient_loss(rec_b, real_b, sw)) / 2
    loss_grad_id = (basic.gradient_loss(id_a, real_a, sw)
                    + basic.gradient_loss(id_b, real_b, sw)) / 2
    win = dict(win_size=loss_cfg.ssim_win_size,
               win_sigma=loss_cfg.ssim_win_sigma, sample_weight=sw)
    loss_ssim = 1.0 - (ssim_mod.ssim(rec_a, real_a, **win)
                       + ssim_mod.ssim(rec_b, real_b, **win)) / 2
    loss_ca = contrast.contrast_attention_loss(
        fake_b, real_b, real_a,
        sigma=loss_cfg.contrast_attention_sigma,
        min_weight=loss_cfg.contrast_attention_min_weight,
        max_weight=loss_cfg.contrast_attention_max_weight,
        blur_kernel=loss_cfg.contrast_attention_blur_kernel,
        sample_weight=sw)
    loss_cr = contrast.contrast_region_loss(
        fake_b, real_b, real_a,
        threshold=loss_cfg.contrast_region_threshold,
        weight=loss_cfg.contrast_region_weight,
        pool=loss_cfg.contrast_region_pool, sample_weight=sw)
    loss_ce = contrast.contrast_edge_loss(
        fake_b, real_b, topk_frac=loss_cfg.edge_topk_frac, sample_weight=sw,
        n_real=n_real)
    total = (loss_gan
             + cfg.lambda_cyc * loss_cycle
             + cfg.lambda_id * loss_id
             + cfg.lambda_grad * loss_grad_cycle
             + cfg.lambda_grad_id * loss_grad_id
             + cfg.lambda_ssim * loss_ssim
             + cfg.lambda_contrast_attention * loss_ca
             + cfg.lambda_contrast_region * loss_cr
             + cfg.lambda_contrast_edge * loss_ce)
    return LossTerms(total, loss_gan, loss_cycle, loss_id, loss_grad_cycle,
                     loss_grad_id, loss_ssim, loss_ca, loss_cr, loss_ce)


def discriminator_loss(real_logits, fake_logits, sample_weight=None):
    """(MSE(D(real), 1) + MSE(D(fake), 0)) / 2 (trainer.py:518, 523); the
    caller detaches the fakes."""
    return (basic.lsgan_real(real_logits.float(), sample_weight)
            + basic.lsgan_fake(fake_logits.float(), sample_weight)) / 2


def validation_generator_loss(*, real_a, real_b, fake_a, fake_b, rec_a, rec_b,
                              id_a, id_b, d_a_fake_logits, d_b_fake_logits,
                              cfg: TrainConfig, sample_weight=None):
    """GAN + l_cyc*cycle + l_id*identity only (trainer.py:243-247)."""
    real_a, real_b, rec_a, rec_b, id_a, id_b = map(
        _squeeze, (real_a, real_b, rec_a, rec_b, id_a, id_b))
    loss_id, loss_gan, loss_cycle = _id_gan_cycle(
        real_a, real_b, rec_a, rec_b, id_a, id_b, d_a_fake_logits,
        d_b_fake_logits, sample_weight)
    return loss_gan + cfg.lambda_cyc * loss_cycle + cfg.lambda_id * loss_id
