"""The training slice-pair dataset with the port's resize.

``SlicePairDataset`` is the JAX package's (ducosy_tpu/data/dataset.py:77),
which decodes a NCCT/CECT pair, applies the HU window and soft squeeze, and
builds the mask channels on the host in numpy. Only its image resize
imports JAX (``_resize_bilinear_aa``, :30-39, used at :109-110); this
subclass reads a sample the same way and resizes with the port's
``ops/resize.py`` weights (jax's linear + antialias) on CPU tensors.
The JAX package's ``HostLoader`` batches it as it is.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ducosy_tpu.data import dataset as _ds
from ducosy_tpu.masks import generate_anatomical_masks
from ducosy_tpu_torch.ops.resize import resize_hw


def resize_bilinear_aa(img: np.ndarray, size: int) -> np.ndarray:
    """jax.image.resize(linear, antialias=True) of a 2-D image on the host."""
    if img.shape == (size, size):
        return img
    return resize_hw(torch.from_numpy(np.ascontiguousarray(img, np.float32)),
                     size, size).numpy()


class SlicePairDataset(_ds.SlicePairDataset):
    """Indexable (NCCT, CECT, masks) samples as NHWC float32 numpy arrays:
    ``a`` and ``b`` (S, S, 1), ``masks`` (S, S, M) when the range uses
    masks."""

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ncct_path, cect_path, mask_paths = self.pairs[index]
        cfg, size = self.range_cfg, self.img_size
        raw_hu = _ds._load_hu(ncct_path)
        a, b = (_ds._hu_transform_np(hu, cfg.hu_min, cfg.hu_max,
                                     cfg.use_soft_squeezing)
                for hu in (raw_hu, _ds._load_hu(cect_path)))
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
                        _ds._resize_nearest(m.astype(np.float32), size))
            else:
                for folder in cfg.mask_folders:
                    m = _read_mask(mask_paths.get(folder))
                    if m is None:
                        m = np.zeros((size, size), np.float32)
                    channels.append(_ds._resize_nearest(m, size))
            if channels:
                out["masks"] = np.stack(channels, axis=-1).astype(np.float32)
        return out


def _read_mask(path):
    """A precomputed mask DICOM binarized at > 0, or None if unreadable
    (dataset.py:124-135)."""
    if path is None:
        return None
    try:
        return (_ds.dcmread(path).pixel_array > 0).astype(np.float32)
    except Exception:
        return None
