"""The CycleGAN loss suite in plain float32 PyTorch (qqaazz0222/DuCoSy-GAN,
modules/trainer.py:22-184 and :347-358, :462-525), on (N, 1, H, W) images.

  GAN        LSGAN: MSE of each discriminator's logits on the fakes to 1
  cycle      L1(rec_A, A) and L1(rec_B, B), averaged (x10)
  identity   L1(id_A, A) and L1(id_B, B), averaged (x5)
  grad       GradientLoss of the cycle (x5) and identity (x2.5) pairs: L1
             between the absolute finite differences along W and along H
  ssim       1 - SSIM of the cycle pairs, averaged (x2): pytorch_msssim's
             SSIM(data_range=1, win 11, sigma 1.5), valid filtering
  attention  ContrastAttentionLoss(fake_B, B, A) (x2): 7x7 average blur
             (zero pad 3, padding counted), weight 1 + 2 (1 - exp(-d / 0.15))
             of d = |blur B - blur A|, mean of weight |blur fake_B - blur B|
  region     ContrastRegionLoss(fake_B, B, A) (x1.5): 8x8 average pools,
             mask sigmoid(5 (B_p - A_p - 0.15)), mean mask |fake_p - B_p| plus
             0.5 (|mean diff| + |std diff|), the std Bessel's, all x1.5
  edge       ContrastEdgeLoss(fake_B, B) (x1): Sobel magnitudes
             sqrt(gx^2 + gy^2 + 1e-6) (zero pad 1): |mean diff| + |std diff|
             + |diff of the means of the top 10%| over the batch
The discriminator loss is (MSE(D(real), 1) + MSE(D(fake), 0)) / 2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WEIGHTS = {"gan": 1.0, "cycle": 10.0, "identity": 5.0, "grad_cycle": 5.0,
           "grad_id": 2.5, "ssim": 2.0, "attention": 2.0, "region": 1.5,
           "edge": 1.0}


def l1(a, b):
    return (a - b).abs().mean()


def gradient_loss(pred, target):
    dx = lambda t: (t[..., :, 1:] - t[..., :, :-1]).abs()
    dy = lambda t: (t[..., 1:, :] - t[..., :-1, :]).abs()
    return l1(dx(pred), dx(target)) + l1(dy(pred), dy(target))


def _gauss_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(x, y, data_range: float = 1.0):
    win = _gauss_window().to(x.device)
    filt = lambda t: F.conv2d(F.conv2d(t, win.view(1, 1, 1, -1)),
                              win.view(1, 1, -1, 1))
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu1, mu2 = filt(x), filt(y)
    s11 = filt(x * x) - mu1 * mu1
    s22 = filt(y * y) - mu2 * mu2
    s12 = filt(x * y) - mu1 * mu2
    cs = (2 * s12 + c2) / (s11 + s22 + c2)
    return (((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs).mean()


def contrast_attention(pred, target, source, sigma=0.15, min_w=1.0,
                       max_w=3.0, k=7):
    blur = lambda t: F.avg_pool2d(t, k, stride=1, padding=k // 2,
                                  count_include_pad=True)
    tb, sb, pb = blur(target), blur(source), blur(pred)
    weight = min_w + (max_w - min_w) * (1 - torch.exp(-(tb - sb).abs()
                                                      / sigma))
    return (weight * (pb - tb).abs()).mean()


def contrast_region(pred, target, source, threshold=0.15, weight=1.5,
                    pool=8):
    pp, tp, sp = (F.avg_pool2d(t, pool) for t in (pred, target, source))
    mask = torch.sigmoid(5.0 * (tp - sp - threshold))
    region = (mask * (pp - tp).abs()).mean()
    dist = (pred.mean() - target.mean()).abs() + \
        (pred.std() - target.std()).abs()
    return weight * (region + 0.5 * dist)


def _sobel(t):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=t.device).view(1, 1, 3, 3)
    gx = F.conv2d(t, kx, padding=1)
    gy = F.conv2d(t, kx.transpose(2, 3), padding=1)
    return torch.sqrt(gx * gx + gy * gy + 1e-6)


def contrast_edge(pred, target, topk_frac=0.1):
    pe, te = _sobel(pred), _sobel(target)
    k = max(int(pe.numel() * topk_frac), 1)
    top = lambda e: torch.topk(e.flatten(), k).values.mean()
    return (pe.mean() - te.mean()).abs() + (pe.std() - te.std()).abs() + \
        (top(pe) - top(te)).abs()


def generator_terms(real_a, real_b, fake_a, fake_b, rec_a, rec_b, id_a,
                    id_b, d_a_fake, d_b_fake) -> dict:
    """The nine terms (unweighted) and their weighted ``total``."""
    t = {"gan": ((d_b_fake - 1).square().mean()
                 + (d_a_fake - 1).square().mean()) / 2,
         "cycle": (l1(rec_a, real_a) + l1(rec_b, real_b)) / 2,
         "identity": (l1(id_a, real_a) + l1(id_b, real_b)) / 2,
         "grad_cycle": (gradient_loss(rec_a, real_a)
                        + gradient_loss(rec_b, real_b)) / 2,
         "grad_id": (gradient_loss(id_a, real_a)
                     + gradient_loss(id_b, real_b)) / 2,
         "ssim": 1 - (ssim(rec_a, real_a) + ssim(rec_b, real_b)) / 2,
         "attention": contrast_attention(fake_b, real_b, real_a),
         "region": contrast_region(fake_b, real_b, real_a),
         "edge": contrast_edge(fake_b, real_b)}
    t["total"] = sum(WEIGHTS[k] * t[k] for k in WEIGHTS)
    return t


def discriminator_loss(real_logits, fake_logits):
    return ((real_logits - 1).square().mean()
            + fake_logits.square().mean()) / 2
