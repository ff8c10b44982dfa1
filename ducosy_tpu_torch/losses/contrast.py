"""The contrast-enhancement losses (ducosy_tpu/losses/contrast.py;
reference modules/trainer.py:43-184): attention-weighted blurred L1,
enhancement-region L1 plus distribution matching, and edge-sharpness
matching. Inputs are fp32 (N, H, W) in [-1, 1].
"""
from __future__ import annotations

import torch

from ducosy_tpu_torch.losses.basic import wmean, wstd_bessel
from ducosy_tpu_torch.ops.filters import avg_pool, box_blur, sobel_edges


def contrast_attention_loss(pred, target, source, *, sigma=0.15,
                            min_weight=1.0, max_weight=3.0, blur_kernel=7,
                            sample_weight=None):
    """Weighted L1 on blurred images, upweighting regions where contrast
    (|blur(B) - blur(A)|) is large."""
    target_b = box_blur(target, blur_kernel)
    source_b = box_blur(source, blur_kernel)
    diff = (target_b - source_b).abs()
    weight = min_weight + (max_weight - min_weight) * (
        1.0 - torch.exp(-diff / sigma))
    pred_b = box_blur(pred, blur_kernel)
    return wmean(weight * (pred_b - target_b).abs(), sample_weight)


def contrast_region_loss(pred, target, source, *, threshold=0.15, weight=1.5,
                         pool=8, sample_weight=None):
    """Patch-masked L1 over enhancement regions plus a batch mean/std
    (Bessel) distribution term, scaled by ``weight``."""
    pred_p = avg_pool(pred, pool)
    target_p = avg_pool(target, pool)
    source_p = avg_pool(source, pool)
    mask = 1.0 / (1.0 + torch.exp(-5.0 * (target_p - source_p - threshold)))
    region = wmean(mask * (pred_p - target_p).abs(), sample_weight)
    dist = ((wmean(pred, sample_weight) - wmean(target, sample_weight)).abs()
            + (wstd_bessel(pred, sample_weight)
               - wstd_bessel(target, sample_weight)).abs())
    return weight * (region + 0.5 * dist)


def _topk_mean(x_flat, k: int):
    """Mean of the k largest values (torch.topk(...).values.mean(),
    trainer.py:179-181)."""
    return torch.topk(x_flat, k).values.mean()


def contrast_edge_loss(pred, target, source=None, *, topk_frac=0.1,
                       sample_weight=None, n_real=None):
    """|d mean| + |d std| of the Sobel edge magnitudes plus |d top-k mean|.

    With ``sample_weight``, ``n_real`` (the count of real samples) is
    required: padded samples' edges become -inf, so the top-k set, of size
    k = topk_frac * n_real * H * W, is exactly the ragged batch's
    (contrast.py:63-93)."""
    pred_e = sobel_edges(pred)
    target_e = sobel_edges(target)
    stats = ((wmean(pred_e, sample_weight)
              - wmean(target_e, sample_weight)).abs()
             + (wstd_bessel(pred_e, sample_weight)
                - wstd_bessel(target_e, sample_weight)).abs())
    per_sample = pred_e.numel() // pred_e.shape[0]
    if sample_weight is None:
        k = max(int(pred_e.numel() * topk_frac), 1)
        pred_flat, target_flat = pred_e.reshape(-1), target_e.reshape(-1)
    else:
        if n_real is None:
            raise ValueError("sample_weight requires n_real for the top-k "
                             "edge term")
        k = max(int(n_real * per_sample * topk_frac), 1)
        keep = sample_weight.reshape((-1,) + (1,) * (pred_e.dim() - 1)) > 0
        neg = torch.tensor(float("-inf"), dtype=pred_e.dtype,
                           device=pred_e.device)
        pred_flat = torch.where(keep, pred_e, neg).reshape(-1)
        target_flat = torch.where(keep, target_e, neg).reshape(-1)
    topk = (_topk_mean(pred_flat, k) - _topk_mean(target_flat, k)).abs()
    return stats + topk
