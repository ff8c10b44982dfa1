"""Dual-generator serving engine (ducosy_tpu/infer/engine.py:41-560).

Runs the soft-tissue and lung generators over a patient's stored-pixel
volume on a CUDA card, step for step like the JAX engine's
``run_patient``:
  1. pad z to a multiple of ``chunk`` by repeating the last slice;
  2. per chunk: stored -> HU -> each window's [-1, 1] normalization (the
     training-time soft squeeze with ``soft_squeeze``) -> (resize to
     img_size) -> (+ the model's mask channels) -> both generators ->
     (resize back) -> linear decode to stored floats, no rounding;
  3. composite: soft tissue overwrites the raw value inside its window,
     then lung overwrites inside its own (lung wins the shared -150 HU);
  4. z-gaussian (sigma 0.8) over the merged volume;
  5. gaussian3d + unsharp, restore stored values >= 750, int16.
The JAX engine fuses the chunks into one jitted ``lax.map``; here a Python
loop enqueues each chunk's kernels on the current CUDA stream.

``mesh=`` (a ``parallel.data_mesh``: cards, or one card or the CPU listed
more than once) serves data-parallel, as the JAX engine over its ``data``
axis: one replica of each generator per mesh device (int8 weights
quantized per replica), each chunk split into ``len(mesh)`` equal parts,
every part enqueued on its device before any is gathered onto the first
device, where the composite and the z-coupled postprocess run.
``generate_batch`` runs on the first device, as the JAX engine's does not
shard either. A mesh with an ``sp`` axis (nested device lists) raises.

Mask-conditioned checkpoints (stem input channels > 1: image + the range's
anatomical masks, what the training CLI writes for SOFT_TISSUE and LUNG)
get their mask channels from the raw HU on the host (``masks/anatomy.py``,
threaded over z), resized with nearest to the model resolution and uploaded
as int8; ``prefetch_masks`` starts that in a background thread so the next
patient's masks overlap this patient's device work. One model may be
mask-conditioned and the other not.

``trunk`` picks the generator's trunk: "chain" (K1, the default), "mega"
(K7 + K8 per block), "tail" (the training trunk) or "plain".

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

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from ducosy_tpu_torch.config import LUNG, SOFT_TISSUE, InferConfig, \
    RangeConfig
from ducosy_tpu_torch.data.dataset import resize_nearest
from ducosy_tpu_torch.device import require_cuda
from ducosy_tpu_torch.infer.synthesis import composite_volume, \
    synthesize_volume
from ducosy_tpu_torch.masks import generate_anatomical_masks
from ducosy_tpu_torch.models.convert import load_torch_state_dict
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.ops import hu
from ducosy_tpu_torch.ops.quant import INT8_NORM_SCALE, check_quant
from ducosy_tpu_torch.ops.resize import resize_hw
from ducosy_tpu_torch.parallel.mesh import data_mesh


class DualGeneratorEngine:
    """Soft-tissue + lung generators, released 1-channel checkpoints or
    mask-conditioned ones.

    ``st_sd``/``lung_sd`` are generator state dicts in the reference key
    layout (tensors or numpy arrays), e.g. ``load_torch_state_dict`` or
    ``init_generator_state_dict`` output."""

    def __init__(self, st_sd: Dict[str, Any], lung_sd: Dict[str, Any], *,
                 st_range: RangeConfig = SOFT_TISSUE,
                 lung_range: RangeConfig = LUNG, img_size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 trunk: str = "chain", forward: str = "module",
                 quant: str | None = None, trunk_int8: bool = False,
                 soft_squeeze: bool = False, mesh=None):
        # device: default "cuda", or the mesh's first device, which a
        # device named beside a mesh must agree with
        if mesh is None:
            self.mesh = (require_cuda(device or "cuda"),)
        else:
            self.mesh = tuple(require_cuda(d) for d in data_mesh(devices=mesh))
            named = None if device is None else torch.device(device)
            first = self.mesh[0]
            if named is not None and (named.type != first.type or (
                    named.index is not None and first.index is not None
                    and named.index != first.index)):
                raise ValueError(f"device={named} disagrees with the mesh's "
                                 f"first device {first}")
        self.device = self.mesh[0]
        if forward != "module":
            raise NotImplementedError(
                f"forward={forward!r}: the space-to-depth packed forward is "
                "not ported (ROADMAP.md Queue 1, the packed and fused "
                "forwards)")
        if quant is None and trunk_int8:
            quant = "trunk"
        self.quant = check_quant(quant)
        if quant:
            # as the JAX engine names it; DUCOSY_INT8_SCALE moves it
            self.quant_calibration = f"static-{INT8_NORM_SCALE:g}sigma"
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype {compute_dtype}: bfloat16 or "
                             "float32")
        # channel counts come from the checkpoints: 1 (released), or image
        # + the range's mask channels (what the training CLI writes)
        self.st_channels, self.lung_channels = (
            int(np.shape(sd["model.1.weight"])[1]) for sd in (st_sd, lung_sd))
        self.use_masks = max(self.st_channels, self.lung_channels) > 1
        for name, ch, rng in (("soft-tissue", self.st_channels, st_range),
                              ("lung", self.lung_channels, lung_range)):
            if ch > 1 and ch != 1 + len(rng.mask_types):
                raise ValueError(
                    f"{name} checkpoint has {ch} input channels; its range "
                    f"gives 1 + {len(rng.mask_types)} masks {rng.mask_types}")
        # inputs through the training dataset's squeeze for ranges trained
        # with it; the output decode stays linear either way, as the
        # reference's serving path (ducosy_tpu/infer/engine.py:97-106)
        self.soft_squeeze = soft_squeeze
        self._mask_pool = None
        if compute_dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.st_range, self.lung_range = st_range, lung_range
        self.img_size = img_size

        def build(sd, device):
            gen = Generator.from_state_dict(sd, trunk=trunk, quant=quant)
            gen = gen.to(device=device, dtype=compute_dtype)
            gen = gen.to(memory_format=torch.channels_last)
            return gen.eval().requires_grad_(False)

        # (soft-tissue, lung) generators per mesh device
        self.replicas = [(build(st_sd, d), build(lung_sd, d))
                         for d in self.mesh]
        self.st_generator, self.lung_generator = self.replicas[0]

    @classmethod
    def from_torch_checkpoints(cls, st_path: str, lung_path: str, **kw):
        """Load the released ``.pth`` A2B generators (generate.py:29-49)."""
        return cls(load_torch_state_dict(st_path),
                   load_torch_state_dict(lung_path), **kw)

    # ---------------------------------------------------------------- core
    def _normalize(self, hu_img: torch.Tensor, rng: RangeConfig):
        if self.soft_squeeze and rng.use_soft_squeezing:
            # the squeeze expects window-clipped HU, as the dataset gives it
            clipped = torch.clamp(hu_img, rng.hu_min, rng.hu_max)
            return hu.soft_squeeze(clipped, rng.hu_min, rng.hu_max)
        return hu.normalize_window(hu_img, rng.hu_min, rng.hu_max)

    def _forward_impl(self, stored: torch.Tensor, slope: float,
                      intercept: float, out_h: int, out_w: int, masks=None,
                      generators=None):
        """(B, H, W) fp32 stored pixels on a device (+ per-model
        (B, s, s, M) mask channels at model resolution) -> dict of
        stored-float outputs and the raw HU, all on that device, through
        ``generators`` (the replica there; default the first)."""
        st_gen, lung_gen = generators or self.replicas[0]
        hu_img = hu.stored_to_hu(stored, slope, intercept)
        x = torch.stack([self._normalize(hu_img, r)
                         for r in (self.st_range, self.lung_range)])
        if x.shape[-2:] != (self.img_size, self.img_size):
            x = resize_hw(x, self.img_size, self.img_size)
        st_x, lung_x = x[0][..., None], x[1][..., None]
        # image first, then the model's masks; a model without masks has no
        # entry (one may be mask-conditioned and the other not)
        if self.st_channels > 1:
            st_x = torch.cat([st_x, masks["st"].to(st_x.dtype)], dim=-1)
        if self.lung_channels > 1:
            lung_x = torch.cat([lung_x, masks["lung"].to(lung_x.dtype)],
                               dim=-1)
        y = torch.stack([st_gen(st_x)[..., 0], lung_gen(lung_x)[..., 0]])
        if y.shape[-2:] != (out_h, out_w):
            y = resize_hw(y, out_h, out_w)
        st_hu = hu.denormalize_to_hu(y[0], self.st_range.hu_min,
                                     self.st_range.hu_max)
        lung_hu = hu.denormalize_to_hu(y[1], self.lung_range.hu_min,
                                       self.lung_range.hu_max)
        return {"st_stored": hu.hu_to_stored(st_hu, slope, intercept),
                "lung_stored": hu.hu_to_stored(lung_hu, slope, intercept),
                "raw_hu": hu_img}

    @staticmethod
    def _masks_threaded(hu_vol: np.ndarray, mask_types,
                        n_workers: int | None = None) -> Dict[str, np.ndarray]:
        """``generate_anatomical_masks`` over z spans in parallel threads.
        Every detector works slice by slice, so splitting z is exact; scipy
        and numpy release the GIL in the hot loops. One serial call on a
        one-core host or a short volume."""
        if n_workers is None:
            n_workers = min(8, os.cpu_count() or 1)
        z = hu_vol.shape[0] if hu_vol.ndim == 3 else 1
        if n_workers <= 1 or z < 2 * n_workers:
            return generate_anatomical_masks(hu_vol, mask_types)
        bounds = np.linspace(0, z, n_workers + 1, dtype=int)
        spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        with ThreadPoolExecutor(max_workers=len(spans)) as pool:
            parts = list(pool.map(
                lambda ab: generate_anatomical_masks(
                    hu_vol[ab[0]:ab[1]], mask_types), spans))
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _host_masks(self, stored: np.ndarray, slope: float,
                    intercept: float) -> Dict[str, np.ndarray]:
        """The conditioning mask channels from the raw NCCT HU, on the host:
        per mask-conditioned model ("st", "lung") a float32 (Z, s, s, M)
        array of {0, 1} at model resolution (nearest resize), channels in
        the range's ``mask_types`` order."""
        hu_vol = np.asarray(stored, np.float32) * slope + intercept
        ranges = {k: r for k, ch, r in (
            ("st", self.st_channels, self.st_range),
            ("lung", self.lung_channels, self.lung_range)) if ch > 1}
        needed = sorted({t for r in ranges.values() for t in r.mask_types})
        masks = self._masks_threaded(hu_vol, needed) if needed else {}

        def pack(mask_types):
            chans = []
            for name in mask_types:
                m = masks.get(name)
                if m is None:
                    m = np.zeros(hu_vol.shape, np.uint8)
                if m.ndim == 2:
                    m = m[None]
                chans.append(np.stack([
                    resize_nearest(s.astype(np.float32), self.img_size)
                    for s in m]))
            return np.stack(chans, axis=-1).astype(np.float32)

        return {k: pack(r.mask_types) for k, r in ranges.items()}

    def prefetch_masks(self, stored_volume: np.ndarray, slope: float,
                       intercept: float):
        """Start computing a patient's masks in a background thread; pass
        the returned future to ``run_patient_async(masks=...)`` so patient
        N+1's masks overlap patient N's device work. None for engines
        without mask-conditioned checkpoints."""
        if not self.use_masks:
            return None
        if self._mask_pool is None:
            self._mask_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="mask-prefetch")
        vol = np.ascontiguousarray(stored_volume)
        return self._mask_pool.submit(self._host_masks, vol, slope, intercept)

    def _upload_masks(self, masks, stored_volume, slope, intercept, pad: int):
        """A ``prefetch_masks`` future, its result, or None (computed here)
        -> per-model int8 device tensors, z padded by copies of the last
        slice's mask."""
        if not self.use_masks:
            return None
        if masks is None:
            masks = self._host_masks(stored_volume, slope, intercept)
        elif hasattr(masks, "result"):
            masks = masks.result()
        if pad:
            masks = {k: np.concatenate([v, v[-1:].repeat(pad, axis=0)])
                     for k, v in masks.items()}
        return {k: torch.from_numpy(np.asarray(v).astype(np.int8))
                .to(self.device) for k, v in masks.items()}

    def _upload(self, stored: np.ndarray) -> torch.Tensor:
        """Host stored pixels -> device tensor in a narrow integer dtype
        (uint16 widens to int32 on the host: torch has no uint16 math)."""
        arr = np.ascontiguousarray(stored)
        if arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    def generate_batch(self, stored: np.ndarray, slope: float,
                       intercept: float, *, chunk: int | None = None
                       ) -> Dict[str, np.ndarray]:
        """A (B, H, W) batch through both models: float32 stored-pixel
        outputs and the raw HU, as numpy, at the input's size. With
        ``chunk`` the models take ``chunk`` slices a call (the last call
        the rest), so a whole patient fits on the card; the same math."""
        out_h, out_w = stored.shape[-2:]
        slope, intercept = float(slope), float(intercept)
        step = chunk or len(stored)
        parts = []
        with torch.inference_mode():
            masks = self._upload_masks(None, stored, slope, intercept, 0)
            for lo in range(0, len(stored), step):
                sl = self._upload(stored[lo:lo + step]).to(torch.float32)
                mk = masks and {k: v[lo:lo + step] for k, v in masks.items()}
                out = self._forward_impl(sl, slope, intercept, out_h, out_w,
                                         mk)
                parts.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _forward_parts(self, sl, slope, intercept, h, w, masks):
        """One chunk through ``_forward_impl``: whole on one device, or in
        ``len(mesh)`` equal parts, each on its replica, all enqueued before
        the outputs are gathered onto the first device."""
        if len(self.mesh) == 1:
            return self._forward_impl(sl, slope, intercept, h, w, masks)
        rows = len(sl) // len(self.mesh)
        outs = []
        for i, (dev, gens) in enumerate(zip(self.mesh, self.replicas)):
            part = slice(i * rows, (i + 1) * rows)
            mk = masks and {k: v[part].to(dev) for k, v in masks.items()}
            outs.append(self._forward_impl(sl[part].to(dev), slope, intercept,
                                           h, w, mk, gens))
        return {k: torch.cat([o[k].to(self.device) for o in outs])
                for k in outs[0]}

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
                          sharpen_radius: float = 1.2,
                          masks=None) -> torch.Tensor:
        """Like run_patient, but returns the int16 volume as a device tensor
        without waiting for the card, so a caller can overlap host work.
        ``masks`` may be a ``prefetch_masks`` future (or its result) of the
        same unpadded volume; without it a mask-conditioned engine computes
        the masks here. With a mesh, ``chunk`` must divide by its size."""
        z, h, w = stored_volume.shape
        if chunk % len(self.mesh):
            raise ValueError(f"chunk={chunk} not divisible by data-axis size "
                             f"{len(self.mesh)}")
        pad = (-z) % chunk
        stored = np.concatenate(
            [stored_volume, stored_volume[-1:].repeat(pad, axis=0)]
        ) if pad else stored_volume
        slope, intercept = float(slope), float(intercept)
        with torch.inference_mode():
            masks = self._upload_masks(masks, stored_volume, slope, intercept,
                                       pad)
            vol = self._upload(stored)
            merged = torch.empty((z + pad, h, w), dtype=torch.float32,
                                 device=self.device)
            for lo in range(0, z + pad, chunk):
                sl = vol[lo:lo + chunk].to(torch.float32)
                mk = masks and {k: v[lo:lo + chunk] for k, v in masks.items()}
                out = self._forward_parts(sl, slope, intercept, h, w, mk)
                merged[lo:lo + chunk] = composite_volume(
                    sl, out["raw_hu"], out["st_stored"], out["lung_stored"],
                    self.st_range, self.lung_range)
            return synthesize_volume(merged[:z], InferConfig(
                pre_z_sigma=pre_z_sigma, sigma_z=sigma_z, sigma_xy=sigma_xy,
                sharpen_amount=sharpen_amount, sharpen_radius=sharpen_radius))
