"""SSIM and MS-SSIM compatible with pytorch_msssim
(ducosy_tpu/losses/ssim.py).

The reference trains with ``pytorch_msssim.SSIM(data_range=1.0,
size_average=True, channel=1)`` on [-1, 1] cycle reconstructions, as
1 - SSIM (modules/trainer.py:351, 485): separable 11-tap gaussian window
(sigma 1.5), VALID filtering, K1 = 0.01, K2 = 0.03, biased statistics.
``ms_ssim`` is the evaluation suite's 5-scale form (calculate.py:274-291).
Both run on the input's device in fp32.
"""
from __future__ import annotations

import numpy as np

from ducosy_tpu_torch.losses.basic import wmean
from ducosy_tpu_torch.ops.filters import apply_hw

_K1 = 0.01
_K2 = 0.03
MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float) -> tuple:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32).astype(np.float64))


def _to_nhw(x):
    """Fold any channel dim into the batch: (N, H, W, C) -> (N*C, H, W)."""
    if x.dim() == 3:
        return x, 1
    n, h, w, c = x.shape
    return x.movedim(-1, 1).reshape(n * c, h, w), c


def _ssim_maps(x, y, win, data_range):
    """(ssim map, contrast-structure map) of (N, H, W) fp32 tensors."""
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    f = lambda a: apply_hw(a, ("valid", win), ("valid", win))
    mu1, mu2 = f(x), f(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f(x * x) - mu1_sq
    sigma2_sq = f(y * y) - mu2_sq
    sigma12 = f(x * y) - mu12
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map, cs_map


def ssim(x, y, *, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5, sample_weight=None):
    """Mean SSIM of (N, H, W) or NHWC tensors; with an (N,) sample_weight,
    the mean over the weighted samples."""
    win = _gaussian_window(win_size, win_sigma)
    x3, c = _to_nhw(x)
    y3, _ = _to_nhw(y)
    smap, _ = _ssim_maps(x3.float(), y3.float(), win, data_range)
    if sample_weight is None:
        return smap.mean()
    return wmean(smap, sample_weight.repeat_interleave(c))


def ssim_loss(x, y, **kw):
    """1 - SSIM, the training loss form (trainer.py:485)."""
    return 1.0 - ssim(x, y, **kw)


def _avg_pool_2x(x):
    """2x2 stride-2 average pool of (N, H, W), an odd row or column
    dropped (pytorch_msssim's avg_pool2d on odd shapes)."""
    n, h, w = x.shape
    x = x[:, :h - h % 2, :w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def ms_ssim(x, y, *, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, weights=MS_WEIGHTS,
            return_per_sample: bool = False):
    """Multi-scale SSIM of (N, H, W) or NHWC tensors (torchmetrics and
    pytorch_msssim defaults); H and W must exceed (win_size - 1) * 2^4.

    Each level's mean is clamped at 0. With ``return_per_sample`` also an
    (N,) tensor of per-sample values, each from the sample's own maps; the
    batch value stays the mean over the batch's maps, as torchmetrics
    computes it."""
    win = _gaussian_window(win_size, win_sigma)
    x, _ = _to_nhw(x)
    y, _ = _to_nhw(y)
    x, y = x.float(), y.float()
    levels = len(weights)
    mcs, mcs_ps = [], []
    for i in range(levels):
        ssim_map, cs_map = _ssim_maps(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(cs_map.mean().clamp_min(0.0))
            mcs_ps.append(cs_map.mean(dim=(1, 2)).clamp_min(0.0))
            x, y = _avg_pool_2x(x), _avg_pool_2x(y)
    value = ssim_map.mean().clamp_min(0.0)
    value_ps = ssim_map.mean(dim=(1, 2)).clamp_min(0.0)
    result, result_ps = value ** weights[-1], value_ps ** weights[-1]
    for w, cs, cs_ps in zip(weights[:-1], mcs, mcs_ps):
        result = result * cs ** w
        result_ps = result_ps * cs_ps ** w
    return (result, result_ps) if return_per_sample else result
