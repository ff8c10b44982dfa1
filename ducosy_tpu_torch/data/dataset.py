"""The training slice-pair dataset (ducosy_tpu/data/dataset.py).

``SlicePairDataset`` decodes a NCCT/CECT pair, applies the HU window and
soft squeeze, and builds the mask channels on the host in numpy, as the JAX
package's does. The image resize is the port's own: ``ops/resize.py``'s
weights (jax's linear + antialias) on CPU tensors, where the JAX dataset
calls ``jax.image.resize`` (:30-39). ``data/loader.py``'s ``HostLoader``
batches it.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ducosy_tpu_torch.config import RangeConfig
from ducosy_tpu_torch.data.pairing import pair_patient_slices
from ducosy_tpu_torch.dicom import dcmread
from ducosy_tpu_torch.masks import generate_anatomical_masks
from ducosy_tpu_torch.ops.resize import resize_hw


def resize_bilinear_aa(img: np.ndarray, size: int) -> np.ndarray:
    """jax.image.resize(linear, antialias=True) of a 2-D image on the host."""
    if img.shape == (size, size):
        return img
    return resize_hw(torch.from_numpy(np.ascontiguousarray(img, np.float32)),
                     size, size).numpy()


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest resize by index (source index = floor(i * in / out))."""
    if img.shape == (size, size):
        return img
    ys = (np.arange(size) * img.shape[0] / size).astype(np.int64)
    xs = (np.arange(size) * img.shape[1] / size).astype(np.int64)
    return img[np.ix_(ys, xs)]


def _soft_squeeze_np(image, hu_min, hu_max, sigma=50.0):
    normalized = (image - hu_min) / (hu_max - hu_min)
    k = 10.0 / sigma
    soft = 1.0 / (1.0 + np.exp(-k * (normalized - 0.9)))
    out = np.where(normalized < 0.9, normalized, 0.9 + 0.1 * soft)
    return 2.0 * out - 1.0


def _load_hu(path: str) -> np.ndarray:
    """DICOM path -> raw HU array, through the native C parser when it
    could be built (zero-copy pixel view), else the Python codec."""
    from ducosy_tpu_torch.dicom.native import read_slice_any

    info = read_slice_any(path)
    return (info.pixels.astype(np.float32) * info.rescale_slope
            + info.rescale_intercept)


def _hu_transform_np(raw_hu, hu_min, hu_max, use_soft_squeezing):
    img = np.clip(raw_hu, hu_min, hu_max)
    if use_soft_squeezing:
        img = _soft_squeeze_np(img, hu_min, hu_max)
    else:
        img = 2.0 * (img - hu_min) / (hu_max - hu_min) - 1.0
    return img.astype(np.float32)


class SlicePairDataset:
    """Indexable (NCCT, CECT, masks) samples as NHWC float32 numpy arrays:
    ``a`` and ``b`` (S, S, 1), ``masks`` (S, S, M) when the range uses
    masks."""

    def __init__(self, patient_dirs: Sequence[str], range_cfg: RangeConfig,
                 *, img_size: int = 512, ncct_folder: str = "POST VUE",
                 cect_folder: str = "POST STD"):
        self.range_cfg = range_cfg
        self.img_size = img_size
        self.pairs: List[Tuple[str, str, Dict[str, str]]] = []
        for pdir in patient_dirs:
            for ncct, cect in pair_patient_slices(pdir, ncct_folder,
                                                  cect_folder):
                mask_paths: Dict[str, str] = {}
                if range_cfg.use_masks and not range_cfg.auto_generate_masks:
                    for folder in range_cfg.mask_folders:
                        candidate = os.path.join(
                            pdir, folder, os.path.basename(ncct))
                        if os.path.exists(candidate):
                            mask_paths[folder] = candidate
                self.pairs.append((ncct, cect, mask_paths))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ncct_path, cect_path, mask_paths = self.pairs[index]
        cfg, size = self.range_cfg, self.img_size
        raw_hu = _load_hu(ncct_path)
        a, b = (_hu_transform_np(hu, cfg.hu_min, cfg.hu_max,
                                 cfg.use_soft_squeezing)
                for hu in (raw_hu, _load_hu(cect_path)))
        out = {"a": resize_bilinear_aa(a, size)[..., None].astype(np.float32),
               "b": resize_bilinear_aa(b, size)[..., None].astype(np.float32)}
        if cfg.use_masks and (cfg.mask_types or cfg.mask_folders):
            channels: List[np.ndarray] = []
            if cfg.auto_generate_masks:
                masks = generate_anatomical_masks(raw_hu, cfg.mask_types)
                for name in cfg.mask_types:
                    m = masks.get(name)
                    if m is None:
                        m = np.zeros_like(raw_hu, np.uint8)
                    channels.append(
                        resize_nearest(m.astype(np.float32), size))
            else:
                for folder in cfg.mask_folders:
                    m = _read_mask(mask_paths.get(folder))
                    if m is None:
                        m = np.zeros((size, size), np.float32)
                    channels.append(resize_nearest(m, size))
            if channels:
                out["masks"] = np.stack(channels, axis=-1).astype(np.float32)
        return out


def _read_mask(path):
    """A precomputed mask DICOM binarized at > 0, or None if unreadable
    (dataset.py:124-135)."""
    if path is None:
        return None
    try:
        return (dcmread(path).pixel_array > 0).astype(np.float32)
    except Exception:
        return None
