"""nmodel (3-D U-Net difference-map) data pipeline + config: the port's copy
of ducosy_tpu/models/nmodel_data.py (numpy on the host; the samples are
the JAX package's, array for array).

Rebuild of modules/nmodel/dataset.py:8-268 and modules/nmodel/config.py:5-117
(dormant in the reference but part of the API surface):

  CTDiffDataset   — (vue.npy, diff.npy) pairs under `<data_dir>/{vue,
                    diff_map}/<patient>_{vue,diff}.npy`, seeded train/val
                    split, random- or per-slice patch extraction with zero
                    padding, HU/diff normalization to [-1, 1]
  NModelConfig    — the reference's preset hyperparameters with JSON
                    save/load round-trip (config.py:120-131 self-check)
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ducosy_tpu_torch.models.unet3d import normalize_diff, normalize_hu


@dataclass
class NModelConfig:
    """Mirrors modules/nmodel/config.py:10-58 defaults."""

    data_dir: str = "data"
    output_dir: str = "output"
    model_type: str = "standard"  # 'light' or 'standard'
    in_channels: int = 1
    out_channels: int = 1
    base_channels: int = 16
    use_patches: bool = True
    patch_size: Tuple[int, int, int] = (1, 512, 512)
    patches_per_volume: int = 128
    num_epochs: int = 100
    batch_size: int = 1
    learning_rate: float = 5e-5
    num_workers: int = 2
    gradient_accumulation_steps: int = 8
    use_mixed_precision: bool = True
    gradient_clip_value: float = 1.0
    l1_weight: float = 1.0
    ssim_weight: float = 0.0
    val_size: float = 0.15
    save_interval: int = 10

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.output_dir, "checkpoints")

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "NModelConfig":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        data = {k: v for k, v in data.items() if k in known}
        if "patch_size" in data:
            data["patch_size"] = tuple(data["patch_size"])
        return cls(**data)


def _train_val_split(ids: List[str], val_size: float, seed: int
                     ) -> Tuple[List[str], List[str]]:
    """sklearn train_test_split(random_state=seed) where sklearn imports,
    else the seeded shuffle (the JAX package's two branches)."""
    try:
        from sklearn.model_selection import train_test_split
        return train_test_split(ids, test_size=val_size, random_state=seed)
    except ImportError:
        rng = random.Random(seed)
        ids = sorted(ids)
        rng.shuffle(ids)
        n_val = max(1, int(round(len(ids) * val_size)))
        return ids[n_val:], ids[:n_val]


class CTDiffDataset:
    """Indexable (vue_patch, diff_patch) dataset, both normalized [-1, 1],
    shaped (D, H, W, 1) NDHWC."""

    def __init__(self, data_dir: str, mode: str = "train", *,
                 val_size: float = 0.15, random_state: int = 42,
                 use_patches: bool = True,
                 patch_size: Tuple[int, int, int] = (1, 512, 512),
                 patches_per_volume: int = 8, seed: int = 0):
        if mode not in ("train", "val"):
            raise ValueError(f"Unknown mode: {mode}")
        self.data_dir = data_dir
        self.mode = mode
        self.use_patches = use_patches
        self.patch_size = tuple(patch_size)
        self.patches_per_volume = patches_per_volume
        self.rng = np.random.default_rng(seed)

        diff_dir = os.path.join(data_dir, "diff_map")
        ids = sorted(f[: -len("_diff.npy")] for f in os.listdir(diff_dir)
                     if f.endswith("_diff.npy"))
        train_ids, val_ids = _train_val_split(ids, val_size, random_state)
        self.patient_ids = train_ids if mode == "train" else val_ids

    def __len__(self) -> int:
        if self.use_patches:
            return len(self.patient_ids) * self.patches_per_volume
        return len(self.patient_ids)

    def _load(self, pid: str) -> Tuple[np.ndarray, np.ndarray]:
        vue = np.load(os.path.join(self.data_dir, "vue", f"{pid}_vue.npy"))
        diff = np.load(os.path.join(self.data_dir, "diff_map",
                                    f"{pid}_diff.npy"))
        return vue.astype(np.float32), diff.astype(np.float32)

    def _extract(self, volume: np.ndarray, slice_idx: int) -> np.ndarray:
        """Random (train) / deterministic-slice (val) patch with zero padding
        for undersized volumes (dataset.py:58-135)."""
        d, h, w = volume.shape
        pd, ph, pw = self.patch_size
        if pd == 1:
            sidx = min(slice_idx, d - 1)
            sh = self.rng.integers(0, max(h - ph, 0) + 1)
            sw = self.rng.integers(0, max(w - pw, 0) + 1)
            patch = volume[sidx:sidx + 1, sh:sh + ph, sw:sw + pw]
        else:
            sd = self.rng.integers(0, max(d - pd, 0) + 1)
            sh = self.rng.integers(0, max(h - ph, 0) + 1)
            sw = self.rng.integers(0, max(w - pw, 0) + 1)
            patch = volume[sd:sd + pd, sh:sh + ph, sw:sw + pw]
        if patch.shape != self.patch_size:
            padded = np.zeros(self.patch_size, volume.dtype)
            padded[: patch.shape[0], : patch.shape[1],
                   : patch.shape[2]] = patch
            patch = padded
        return patch

    def __getitem__(self, index: int):
        if self.use_patches:
            pid = self.patient_ids[index // self.patches_per_volume]
            slice_idx = index % self.patches_per_volume
        else:
            pid = self.patient_ids[index]
            slice_idx = 0
        vue, diff = self._load(pid)
        # identical crop coordinates for both volumes
        state = self.rng.bit_generator.state
        vpatch = self._extract(vue, slice_idx)
        self.rng.bit_generator.state = state
        dpatch = self._extract(diff, slice_idx)
        v = np.asarray(normalize_hu(vpatch), np.float32)[..., None]
        d = np.asarray(normalize_diff(dpatch), np.float32)[..., None]
        return {"vue": v, "diff": d}
