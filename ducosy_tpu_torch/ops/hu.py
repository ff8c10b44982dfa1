"""Hounsfield-unit transforms on torch tensors (ducosy_tpu/ops/hu.py).

Same formulas as the JAX functions: fp32 math, scalar slope/intercept and
window bounds passed as Python floats.
"""
from __future__ import annotations

import torch

SQUEEZE_THRESHOLD = 0.9  # normalized value where soft squeezing kicks in
SQUEEZE_SIGMA = 50.0     # sigmoid softness (k = 10/sigma)


def soft_squeeze(image, hu_min, hu_max, sigma=SQUEEZE_SIGMA):
    """Nonlinear [-1,1] normalization: linear below 0.9 of the window,
    sigmoid-compressed above it (ducosy_tpu/ops/hu.py:17-32)."""
    normalized = (image - hu_min) / (hu_max - hu_min)
    k = 10.0 / sigma
    soft = 1.0 / (1.0 + torch.exp(-k * (normalized - SQUEEZE_THRESHOLD)))
    result = torch.where(normalized < SQUEEZE_THRESHOLD, normalized,
                         SQUEEZE_THRESHOLD + (1.0 - SQUEEZE_THRESHOLD) * soft)
    return 2.0 * result - 1.0


def stored_to_hu(stored, slope, intercept):
    """Raw stored pixel values -> HU."""
    return stored.to(torch.float32) * slope + intercept


def normalize_window(hu, hu_min, hu_max):
    """HU clipped to the window and mapped linearly to [-1, 1]."""
    clipped = torch.clamp(hu, hu_min, hu_max)
    return 2.0 * (clipped - hu_min) / (hu_max - hu_min) - 1.0


def denormalize_to_hu(x, hu_min, hu_max):
    """[-1, 1] model output -> HU."""
    return (x + 1.0) / 2.0 * (hu_max - hu_min) + hu_min


def hu_to_stored(hu, slope, intercept):
    """HU -> stored pixel value; the caller casts to the DICOM dtype."""
    return (hu - intercept) / slope


def apply_windowing(x, hu_min, hu_max, window_center, window_width):
    """[-1, 1] image -> display window [0, 1] for the validation grids
    (ducosy_tpu/ops/hu.py:72-81): HU, clamped to WC +- WW/2, over WW."""
    hu = denormalize_to_hu(x, hu_min, hu_max)
    lo = window_center - window_width / 2.0
    hi = window_center + window_width / 2.0
    return (torch.clamp(hu, lo, hi) - lo) / window_width
