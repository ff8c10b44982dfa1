"""Elementary losses: MSE (LSGAN), L1 and the finite-difference gradient
loss (ducosy_tpu/losses/basic.py; reference modules/trainer.py:22-40).

Tensors are fp32 (N, H, W) or NHWC; each function returns a scalar. Every
loss takes an optional (N,) ``sample_weight`` of 1/0 entries: means are
then taken over the weighted samples only, so a batch wrap-padded with
duplicates (HostLoader's static batch) gives exactly the loss and the
gradients of the ragged batch.
"""
from __future__ import annotations

import torch


def _expand(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N,) sample weights broadcast to x's rank."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def wmean(x, sample_weight=None):
    """Mean of x; with (N,) weights, the mean over the weighted samples'
    elements only (all samples have equal element counts)."""
    if sample_weight is None:
        return x.mean()
    per_sample = x.numel() // x.shape[0]
    return (x * _expand(sample_weight, x)).sum() / (
        sample_weight.sum() * per_sample)


def wstd_bessel(x, sample_weight=None):
    """Bessel-corrected std over x's (weighted) elements: torch .std()."""
    if sample_weight is None:
        return torch.sqrt((x - x.mean()).square().sum() / (x.numel() - 1))
    w = _expand(sample_weight, x)
    n = sample_weight.sum() * (x.numel() // x.shape[0])
    mean = (x * w).sum() / n
    return torch.sqrt(((x - mean).square() * w).sum() / (n - 1))


def mse(pred, target, sample_weight=None):
    return wmean((pred - target).square(), sample_weight)


def l1(pred, target, sample_weight=None):
    return wmean((pred - target).abs(), sample_weight)


def lsgan_real(logits, sample_weight=None):
    """MSE against an all-ones label map."""
    return wmean((logits - 1.0).square(), sample_weight)


def lsgan_fake(logits, sample_weight=None):
    """MSE against an all-zeros label map."""
    return wmean(logits.square(), sample_weight)


def gradient_loss(pred, target, sample_weight=None):
    """L1 between the finite differences of pred and target along H (axis
    1) and W (axis 2) (GradientLoss, trainer.py:29-40)."""
    dy_p, dy_t = pred.diff(dim=1).abs(), target.diff(dim=1).abs()
    dx_p, dx_t = pred.diff(dim=2).abs(), target.diff(dim=2).abs()
    return (wmean((dx_p - dx_t).abs(), sample_weight)
            + wmean((dy_p - dy_t).abs(), sample_weight))
