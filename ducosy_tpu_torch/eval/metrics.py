"""The 12-metric evaluation suite (ducosy_tpu/eval/metrics.py; reference
calculate.py:243-379), the same conventions:

  mae    mean |a-b| (volume + per-slice)                        (:243-245)
  psnr   20*log10(range(img1)/rmse), img1's dynamic range       (:247-263)
  ssim   skimage-convention SSIM per slice: uniform 7x7 window,
         sample covariance, data_range = range(img2)            (:265-272)
  ms_ssim multi-scale SSIM of min-max normalized volumes        (:274-291)
  lpips  perceptual distance, AlexNet + linear heads (eval/lpips.py)
         from a weights file; NaN when there is none, as the reference
         without its lpips package                              (:293-318)
  emd    per-slice Wasserstein distance of globally normalized
         intensities, over the pixel count                      (:320-338)
  ts     texture similarity 1 - mean|sobel(a)-sobel(b)| / max|sobel|
  cs     cosine similarity of flattened slices                  (:360-367)
  ed     L2 of the per-slice min-max normalized difference / numel

The host metrics (mae, psnr, ssim, emd, ts, cs, ed) are numpy/scipy copies
of the JAX package's, held to them by tests/test_torch_imports.py.
``calculate_ms_ssim`` and ``calculate_lpips`` run on the torch device named
by ``device`` (default cuda; it raises without a card).

Every function takes (img1, img2) as (Z, H, W) float arrays and returns
(volume_value, per_slice_list).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from scipy.ndimage import uniform_filter
from scipy.stats import wasserstein_distance

from ducosy_tpu_torch.device import require_cuda

Pair = Tuple[float, List[float]]


def calculate_mae(img1: np.ndarray, img2: np.ndarray) -> Pair:
    diff = np.abs(img1 - img2)
    return float(np.mean(diff)), [float(np.mean(s)) for s in diff]


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> Pair:
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf"), [float("inf")] * len(img1)
    rng = img1.max() - img1.min()
    max_pixel = rng if rng != 0 else 1.0
    psnr = 20 * np.log10(max_pixel / np.sqrt(mse))
    per = []
    for s1, s2 in zip(img1, img2):
        m = np.mean((s1 - s2) ** 2)
        per.append(float("inf") if m == 0
                   else float(20 * np.log10(max_pixel / np.sqrt(m))))
    return float(psnr), per


def ssim_skimage(s1: np.ndarray, s2: np.ndarray, *, data_range: float,
                 win_size: int = 7, k1: float = 0.01,
                 k2: float = 0.03) -> float:
    """skimage.metrics.structural_similarity defaults: uniform window,
    sample covariance, border crop of (win_size-1)//2."""
    s1 = s1.astype(np.float64)
    s2 = s2.astype(np.float64)
    ns = win_size ** 2
    cov_norm = ns / (ns - 1)
    f = lambda x: uniform_filter(x, size=win_size)
    ux, uy = f(s1), f(s2)
    uxx, uyy, uxy = f(s1 * s1), f(s2 * s2), f(s1 * s2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s_map[pad:-pad, pad:-pad].mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> Pair:
    data_range = float(img2.max() - img2.min())
    per = [ssim_skimage(s1, s2, data_range=data_range)
           for s1, s2 in zip(img1, img2)]
    return float(np.mean(per)), per


def _unit_range(vol: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A volume on ``dev`` min-max normalized to [0, 1] in fp32."""
    v = torch.from_numpy(np.ascontiguousarray(vol, np.float32)).to(dev)
    return (v - v.min()) / (v.max() - v.min() + 1e-8)


def calculate_ms_ssim(img1: np.ndarray, img2: np.ndarray, *,
                      device: str | torch.device = "cuda") -> Pair:
    """Multi-scale SSIM of the min-max normalized volumes, the whole volume
    as one batch (calculate.py:277-289), on ``device``. Needs H and W
    >= 176 and returns NaN otherwise (the reference's exception path).

    The per-slice values are each slice's own MS-SSIM (its own maps, the
    volume-level normalization), where the reference repeats the batch
    value for every slice (calculate.py:288); the volume value stays the
    batch computation, so it still matches torchmetrics."""
    from ducosy_tpu_torch.losses.ssim import ms_ssim

    dev = require_cuda(device)
    if min(img1.shape[1:]) < 176:
        return float("nan"), []
    with torch.inference_mode():
        val, per = ms_ssim(_unit_range(img1, dev), _unit_range(img2, dev),
                           data_range=1.0, return_per_sample=True)
        per = per.cpu().numpy()
    return float(val), [float(v) for v in per]


_LPIPS_CACHE: dict = {}


def calculate_lpips(img1: np.ndarray, img2: np.ndarray, *,
                    weights_path: str | None = None,
                    device: str | torch.device = "cuda") -> Pair:
    """LPIPS(AlexNet) perceptual distance (calculate.py:293-318) on
    ``device``, from a weights file (eval/lpips.py); with no file this
    returns NaN, as the reference does when its lpips import fails
    (calculate.py:33-41, 295)."""
    from ducosy_tpu_torch.eval import lpips as lpips_mod

    dev = require_cuda(device)
    path = weights_path or lpips_mod.default_weights_path()
    if path is None:
        return float("nan"), []
    model = _LPIPS_CACHE.get((path, dev))
    if model is None:
        model = _LPIPS_CACHE[(path, dev)] = lpips_mod.LPIPSAlex(path).to(dev)
    return model.distance(img1, img2)


def calculate_emd(img1: np.ndarray, img2: np.ndarray) -> Pair:
    gmin = min(img1.min(), img2.min())
    gmax = max(img1.max(), img2.max())
    per = []
    for s1, s2 in zip(img1, img2):
        a = (s1 - gmin) / (gmax - gmin + 1e-8)
        b = (s2 - gmin) / (gmax - gmin + 1e-8)
        d = wasserstein_distance(a.ravel(), b.ravel())
        per.append(float(d / np.prod(s1.shape)))
    return float(np.mean(per)), per


def _sobel_mag(img: np.ndarray) -> np.ndarray:
    from scipy.ndimage import sobel as ndsobel
    gx = ndsobel(img, axis=0)
    gy = ndsobel(img, axis=1)
    return np.sqrt(gx ** 2 + gy ** 2)


def calculate_ts(img1: np.ndarray, img2: np.ndarray) -> Pair:
    """1 - normalized gradient difference; invariant to the sobel operator's
    constant scale, so scipy's sobel stands in for skimage's."""
    per = []
    for s1, s2 in zip(img1, img2):
        g1, g2 = _sobel_mag(s1), _sobel_mag(s2)
        diff = np.mean(np.abs(g1 - g2))
        max_grad = max(np.abs(g1).max(), np.abs(g2).max())
        per.append(float(1.0 - (diff / max_grad if max_grad > 0 else 0.0)))
    return float(np.mean(per)), per


def calculate_cs(img1: np.ndarray, img2: np.ndarray) -> Pair:
    per = []
    for s1, s2 in zip(img1, img2):
        v1, v2 = s1.ravel().astype(np.float64), s2.ravel().astype(np.float64)
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        per.append(float(np.dot(v1, v2) / denom) if denom > 0 else 0.0)
    return float(np.mean(per)), per


def calculate_ed(img1: np.ndarray, img2: np.ndarray) -> Pair:
    per = []
    for s1, s2 in zip(img1, img2):
        a = (s1 - s1.min()) / (s1.max() - s1.min() + 1e-8)
        b = (s2 - s2.min()) / (s2.max() - s2.min() + 1e-8)
        per.append(float(np.linalg.norm(a - b) / np.prod(a.shape)))
    return float(np.mean(per)), per


BASIC_METRICS = {
    "mae": calculate_mae,
    "psnr": calculate_psnr,
    "ssim": calculate_ssim,
    "ts": calculate_ts,
    "cs": calculate_cs,
    "ed": calculate_ed,
    "emd": calculate_emd,
}
ADVANCED_METRICS = {
    "ms_ssim": calculate_ms_ssim,
    "lpips": calculate_lpips,
}


def compute_all(img1: np.ndarray, img2: np.ndarray, *,
                advanced: bool = True,
                device: str | torch.device = "cuda") -> dict:
    """All metrics for one volume pair -> {name: (value, per_slice)}; the
    advanced ones on ``device``."""
    out = {name: fn(img1, img2) for name, fn in BASIC_METRICS.items()}
    if advanced:
        for name, fn in ADVANCED_METRICS.items():
            out[name] = fn(img1, img2, device=device)
    return out
