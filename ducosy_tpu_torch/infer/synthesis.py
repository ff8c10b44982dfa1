"""Complementary dual-HU-range synthesis on torch tensors
(ducosy_tpu/infer/synthesis.py; reference generate.py:137-477).

  composite_slice / composite_volume: start from the raw NCCT stored
  pixels, overwrite the pixels whose RAW HU lies in the soft-tissue window
  with the soft-tissue model's output, then those in the lung window with
  the lung model's (lung wins the shared -150 HU, the reference's
  assignment order at generate.py:236-237).

  additive_composite: the v3 test path, which adds each model's HU
  enhancement (where it is above 5 HU and the raw HU above -400) to the
  NCCT in stored units (generate.py:390-415).

  synthesize_volume: the volume postprocess after compositing (z gaussian
  sigma 0.8, then gaussian3d sigma_z 0.7 / sigma_xy 0.05 with unsharp
  1.7 / 1.2; generate.py:254-263): the final int16 volume.

Everything runs on the inputs' device; numpy inputs are taken as CPU
tensors. The DICOM tag surgery lives in the CLI (cli/generate.py).
"""
from __future__ import annotations

import torch

from ducosy_tpu_torch.config import LUNG, SOFT_TISSUE, InferConfig, RangeConfig
from ducosy_tpu_torch.infer.postprocess import postprocess_ct_volume
from ducosy_tpu_torch.ops.filters import gaussian_filter_1d


def _in_window(raw_hu, rng: RangeConfig):
    return (raw_hu >= rng.hu_min) & (raw_hu <= rng.hu_max)


def composite_volume(raw_stored, raw_hu, st_stored, lung_stored,
                     st_range: RangeConfig = SOFT_TISSUE,
                     lung_range: RangeConfig = LUNG):
    """HU-window-gated overwrite compositing of (Z, H, W) or (H, W) arrays;
    the result takes ``torch.where``'s promoted dtype (float when the model
    outputs are), never a truncating in-place store."""
    raw_stored, raw_hu, st_stored, lung_stored = (
        torch.as_tensor(a) for a in (raw_stored, raw_hu, st_stored,
                                     lung_stored))
    merged = torch.where(_in_window(raw_hu, st_range), st_stored, raw_stored)
    return torch.where(_in_window(raw_hu, lung_range), lung_stored, merged)


def composite_slice(raw_stored, raw_hu, st_stored, lung_stored,
                    st_range: RangeConfig = SOFT_TISSUE,
                    lung_range: RangeConfig = LUNG):
    """``composite_volume`` of one (H, W) slice (generate.py:218-237)."""
    return composite_volume(raw_stored, raw_hu, st_stored, lung_stored,
                            st_range, lung_range)


def additive_composite(raw_stored, raw_hu, st_hu, lung_hu, slope: float, *,
                       enhancement_threshold: float = 5.0,
                       valid_hu_floor: float = -400.0):
    """The synthesis_test additive path (generate.py:377-415): fp32 raw
    stored values plus, for each model, ``enhancement / slope`` where its
    enhancement (model HU - raw HU) is above ``enhancement_threshold`` and
    the raw HU above ``valid_hu_floor``."""
    raw_hu = torch.as_tensor(raw_hu)
    merged = torch.as_tensor(raw_stored).to(torch.float32).clone()
    valid = raw_hu > valid_hu_floor
    for model_hu in (st_hu, lung_hu):
        enhancement = torch.as_tensor(model_hu) - raw_hu
        mask = (enhancement > enhancement_threshold) & valid
        merged[mask] += enhancement[mask] / slope
    return merged


def synthesize_volume(merged_volume, cfg: InferConfig = InferConfig()):
    """The volume postprocess after compositing (generate.py:254-263):
    z gaussian (cfg.pre_z_sigma), then gaussian3d + unsharp with the
    stored values >= 750 restored; int16 on the input's device."""
    vol = torch.as_tensor(merged_volume).to(torch.float32)
    vol = gaussian_filter_1d(vol, cfg.pre_z_sigma, axis=0)
    return postprocess_ct_volume(
        vol, "gaussian3d", sigma_z=cfg.sigma_z, sigma_xy=cfg.sigma_xy,
        enhance_sharpness=True, sharpen_amount=cfg.sharpen_amount,
        sharpen_radius=cfg.sharpen_radius)
