"""Dual-generator serving engine (ducosy_tpu/infer/engine.py:41-312, 379-560).

Runs the soft-tissue and lung generators over a patient's stored-pixel
volume on one CUDA card, step for step like the JAX engine's
``run_patient``:
  1. pad z to a multiple of ``chunk`` by repeating the last slice;
  2. per chunk: stored -> HU -> each window's [-1, 1] normalization ->
     (resize to img_size) -> both generators -> (resize back) -> decode to
     stored floats, no rounding;
  3. composite: soft tissue overwrites the raw value inside its window,
     then lung overwrites inside its own (lung wins the shared -150 HU);
  4. z-gaussian (sigma 0.8) over the merged volume;
  5. gaussian3d + unsharp, restore stored values >= 750, int16.
The JAX engine fuses the chunks into one jitted ``lax.map``; here a Python
loop enqueues each chunk's kernels on the current CUDA stream.

bf16 is the serving default; fp32 is the parity mode and switches cuDNN
and matmul TF32 off (process-wide) so fp32 means fp32.

``quant="trunk"|"full"`` (``trunk_int8=True`` is "trunk") is quantized
serving, as the JAX engine's (ducosy_tpu/infer/engine.py:158-179). The JAX
package runs it in its packed (space-to-depth) forward only; the port has
no packed forward (``forward="packed"`` raises), so the quantized modes
live in its single true-layout forward (models/generator.py), with the
int8 weights quantized once from the state dict's fp32 values.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ducosy_tpu.config import LUNG, SOFT_TISSUE, RangeConfig
from ducosy_tpu_torch.device import require_cuda
from ducosy_tpu_torch.infer.postprocess import postprocess_volume
from ducosy_tpu_torch.models.convert import load_torch_state_dict
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.ops import hu
from ducosy_tpu_torch.ops.filters import gaussian_filter_1d
from ducosy_tpu_torch.ops.quant import INT8_NORM_SCALE, check_quant
from ducosy_tpu_torch.ops.resize import resize_hw


class DualGeneratorEngine:
    """Soft-tissue + lung generators for 1-channel (released) checkpoints.

    ``st_sd``/``lung_sd`` are generator state dicts in the reference key
    layout (tensors or numpy arrays), e.g. ``load_torch_state_dict`` or
    ``init_generator_state_dict`` output."""

    def __init__(self, st_sd: Dict[str, Any], lung_sd: Dict[str, Any], *,
                 st_range: RangeConfig = SOFT_TISSUE,
                 lung_range: RangeConfig = LUNG, img_size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", trunk: str = "chain",
                 forward: str = "module", quant: str | None = None,
                 trunk_int8: bool = False, mesh=None):
        self.device = require_cuda(device)
        if forward != "module":
            raise NotImplementedError(
                f"forward={forward!r}: the space-to-depth packed forward is "
                "not ported (ROADMAP.md Queue 1, item 6)")
        if quant is None and trunk_int8:
            quant = "trunk"
        self.quant = check_quant(quant)
        if quant:
            # as the JAX engine names it; DUCOSY_INT8_SCALE moves it
            self.quant_calibration = f"static-{INT8_NORM_SCALE:g}sigma"
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving is not ported (ROADMAP.md Queue 1, "
                "item 9)")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype {compute_dtype}: bfloat16 or "
                             "float32")
        in_ch = [int(np.shape(sd["model.1.weight"])[1])
                 for sd in (st_sd, lung_sd)]
        if max(in_ch) > 1:
            raise NotImplementedError(
                f"mask-conditioned checkpoints (stem input channels {in_ch}) "
                "are not ported (ROADMAP.md Queue 1, item 3: masks and resize "
                "in the mask path)")
        if compute_dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.st_range, self.lung_range = st_range, lung_range
        self.img_size = img_size

        def build(sd):
            gen = Generator.from_state_dict(sd, trunk=trunk, quant=quant)
            gen = gen.to(device=self.device, dtype=compute_dtype)
            gen = gen.to(memory_format=torch.channels_last)
            return gen.eval().requires_grad_(False)

        self.st_generator = build(st_sd)
        self.lung_generator = build(lung_sd)

    @classmethod
    def from_torch_checkpoints(cls, st_path: str, lung_path: str, **kw):
        """Load the released ``.pth`` A2B generators (generate.py:29-49)."""
        return cls(load_torch_state_dict(st_path),
                   load_torch_state_dict(lung_path), **kw)

    # ---------------------------------------------------------------- core
    def _forward_impl(self, stored: torch.Tensor, slope: float,
                      intercept: float, out_h: int, out_w: int):
        """(B, H, W) fp32 stored pixels on the device -> dict of stored-float
        outputs and the raw HU, all on the device."""
        hu_img = hu.stored_to_hu(stored, slope, intercept)
        x = torch.stack([
            hu.normalize_window(hu_img, r.hu_min, r.hu_max)
            for r in (self.st_range, self.lung_range)])
        if x.shape[-2:] != (self.img_size, self.img_size):
            x = resize_hw(x, self.img_size, self.img_size)
        y = torch.stack([self.st_generator(x[0][..., None])[..., 0],
                         self.lung_generator(x[1][..., None])[..., 0]])
        if y.shape[-2:] != (out_h, out_w):
            y = resize_hw(y, out_h, out_w)
        st_hu = hu.denormalize_to_hu(y[0], self.st_range.hu_min,
                                     self.st_range.hu_max)
        lung_hu = hu.denormalize_to_hu(y[1], self.lung_range.hu_min,
                                       self.lung_range.hu_max)
        return {"st_stored": hu.hu_to_stored(st_hu, slope, intercept),
                "lung_stored": hu.hu_to_stored(lung_hu, slope, intercept),
                "raw_hu": hu_img}

    def _composite(self, raw_stored, raw_hu, st_stored, lung_stored):
        """Complementary compositing (generate.py:224-237): soft tissue
        first, lung second, so lung wins the shared boundary."""
        st = self.st_range
        lung = self.lung_range
        st_mask = (raw_hu >= st.hu_min) & (raw_hu <= st.hu_max)
        lung_mask = (raw_hu >= lung.hu_min) & (raw_hu <= lung.hu_max)
        merged = torch.where(st_mask, st_stored, raw_stored)
        return torch.where(lung_mask, lung_stored, merged)

    def _upload(self, stored: np.ndarray) -> torch.Tensor:
        """Host stored pixels -> device tensor in a narrow integer dtype
        (uint16 widens to int32 on the host: torch has no uint16 math)."""
        arr = np.ascontiguousarray(stored)
        if arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    def generate_batch(self, stored: np.ndarray, slope: float,
                       intercept: float) -> Dict[str, np.ndarray]:
        """A (B, H, W) batch through both models: float32 stored-pixel
        outputs and the raw HU, as numpy, at the input's size."""
        out_h, out_w = stored.shape[-2:]
        with torch.inference_mode():
            sl = self._upload(stored).to(torch.float32)
            out = self._forward_impl(sl, float(slope), float(intercept),
                                     out_h, out_w)
            return {k: v.cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------- full-patient pipeline
    def run_patient(self, stored_volume: np.ndarray, slope: float,
                    intercept: float, **kw) -> np.ndarray:
        """Whole patient: the final int16 stored-pixel volume as numpy.
        Keywords as ``run_patient_async``."""
        return self.run_patient_async(stored_volume, slope, intercept,
                                      **kw).cpu().numpy()

    def run_patient_async(self, stored_volume: np.ndarray, slope: float,
                          intercept: float, *, chunk: int = 32,
                          pre_z_sigma: float = 0.8, sigma_z: float = 0.7,
                          sigma_xy: float = 0.05, sharpen_amount: float = 1.7,
                          sharpen_radius: float = 1.2) -> torch.Tensor:
        """Like run_patient, but returns the int16 volume as a device tensor
        without waiting for the card, so a caller can overlap host work."""
        z, h, w = stored_volume.shape
        pad = (-z) % chunk
        stored = np.concatenate(
            [stored_volume, stored_volume[-1:].repeat(pad, axis=0)]
        ) if pad else stored_volume
        slope, intercept = float(slope), float(intercept)
        with torch.inference_mode():
            vol = self._upload(stored)
            merged = torch.empty((z + pad, h, w), dtype=torch.float32,
                                 device=self.device)
            for lo in range(0, z + pad, chunk):
                sl = vol[lo:lo + chunk].to(torch.float32)
                out = self._forward_impl(sl, slope, intercept, h, w)
                merged[lo:lo + chunk] = self._composite(
                    sl, out["raw_hu"], out["st_stored"], out["lung_stored"])
            merged = gaussian_filter_1d(merged[:z], pre_z_sigma, axis=0)
            return postprocess_volume(
                merged, sigma_z=sigma_z, sigma_xy=sigma_xy,
                sharpen_amount=sharpen_amount, sharpen_radius=sharpen_radius)
