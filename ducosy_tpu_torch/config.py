"""Typed configuration for the whole pipeline.

Replaces the reference's three-tier argparse system (the shared flags in
modules/argmanager.py:85-118, the shared inference flags :4-49, and the
hard-coded per-HU-range Namespaces :121-152) with frozen dataclasses. The
numeric defaults reproduce the reference's reproduction contract
(README.md:192-202, modules/argmanager.py:93-111).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class RangeConfig:
    """One HU-range specialization (one CycleGAN).

    Mirrors get_soft_tissue_train_args / get_lung_train_args
    (reference modules/argmanager.py:121-152).
    """

    name: str
    hu_min: float
    hu_max: float
    window_center: float
    window_width: float
    use_soft_squeezing: bool = True
    use_cbam: bool = True
    use_masks: bool = True
    auto_generate_masks: bool = True
    # Masks appended as extra generator input channels, in this order.
    mask_types: tuple[str, ...] = ()
    # Folder names when loading precomputed per-slice mask DICOMs instead.
    mask_folders: tuple[str, ...] = ()

    @property
    def input_channels(self) -> int:
        """1 image channel + one channel per mask (trainer.py:319-324)."""
        if self.use_masks and self.mask_types:
            return 1 + len(self.mask_types)
        return 1


SOFT_TISSUE = RangeConfig(
    name="soft_tissue",
    hu_min=-150.0,
    hu_max=250.0,
    window_center=40.0,
    window_width=400.0,
    mask_types=("bone", "mediastinum"),
    mask_folders=("bone_mask", "mediastinum_mask"),
)

LUNG = RangeConfig(
    name="lung",
    hu_min=-1000.0,
    hu_max=-150.0,
    window_center=-600.0,
    window_width=1500.0,
    mask_types=("lung",),
    mask_folders=("lung_mask",),
)

RANGES = {"soft_tissue": SOFT_TISSUE, "lung": LUNG}


@dataclass(frozen=True)
class ModelConfig:
    """Generator/discriminator architecture (reference modules/model.py)."""

    num_residual_blocks: int = 9
    base_channels: int = 64
    cbam_reduction: int = 16
    cbam_spatial_kernel: int = 7
    disc_base_channels: int = 64
    output_channels: int = 1
    # the trunk's 18 InstanceNorms on K2 (backward K3), the JAX package's
    # fused-InstanceNorm switch; runs on the module forward's plain trunk
    fused_norm: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (argmanager.py:85-118, trainer.py:346-367)."""

    epochs: int = 10_000
    decay_epoch: int = 100
    batch_size: int = 8  # global batch across the data mesh axis
    lr: float = 2e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    lambda_cyc: float = 10.0
    lambda_id: float = 5.0
    lambda_grad: float = 5.0
    lambda_grad_id: float = 2.5
    lambda_ssim: float = 2.0
    lambda_contrast_attention: float = 2.0
    lambda_contrast_region: float = 1.5
    lambda_contrast_edge: float = 1.0
    img_size: int = 512
    val_split: float = 0.2
    split_seed: int = 42
    init_seed: int = 0
    num_workers: int = 16
    # bf16 compute (fp32 norm statistics and losses); fp32 params.
    compute_dtype: str = "bfloat16"
    data_root: str = "./data/train"
    dataset_names: str = ""
    ncct_folder: str = "POST VUE"
    cect_folder: str = "POST STD"
    training_dir: str = "./training_dir"
    resume: str = "checkpoint"  # checkpoint name under training_dir; "" = fresh
    # retention for per-epoch G_*_epoch_{N}.npz snapshots: keep the newest
    # K (best/last/full-state checkpoints are never pruned); 0 = keep all
    # (the reference's unbounded behavior, trainer.py:572-573)
    checkpoint_keep: int = 3
    log_every: int = 10
    # generator-forward rematerialization inside the train step:
    # "auto" tries without and falls back to remat when the step runs out
    # of device memory; "on"/"off" force it.
    remat: str = "auto"
    # the train step's generator forward: "packed" is the space-to-depth
    # forward (models/fused.py), "module" the module forward; "auto" is
    # "packed" on a card (img_size % 4 == 0) unless a module trunk or
    # fused_norm is named, else "module" (resolve.training_forward)
    gen_forward: str = "auto"
    # the JAX package's profiler-trace window (unused by the port)
    profile_dir: str = ""
    profile_start: int = 5
    profile_stop: int = 8


@dataclass(frozen=True)
class InferConfig:
    """Inference/synthesis settings (argmanager.py:4-49, generate.py)."""

    img_size: int = 512
    slice_batch: int = 32  # batch slices under one jit (ref loops batch=1)
    window_center: float = 40.0
    window_width: float = 400.0
    data_dir_root: str = "./data"
    input_dir_root: str = "./data/input"
    working_dir_root: str = "./data/working"
    output_dir_root: str = "./data/output"
    dataset_names: tuple[str, ...] = ()
    ncct_folder: str = "POST VUE"
    cect_folder: str = "POST STD"
    soft_tissue_ckpt: str = "./checkpoints/v3/Soft_Tissue_Generator_A2B.pth"
    lung_ckpt: str = "./checkpoints/v3/Lung_Generator_A2B.pth"
    compute_dtype: str = "bfloat16"
    # Volume postprocess (generate.py:254-263)
    pre_z_sigma: float = 0.8
    sigma_z: float = 0.7
    sigma_xy: float = 0.05
    sharpen_amount: float = 1.7
    sharpen_radius: float = 1.2
    series_description: str = "DuCoSyGAN sCECT v2"


@dataclass(frozen=True)
class LossConfig:
    """Fixed loss-function hyperparameters (trainer.py:346-358)."""

    contrast_attention_sigma: float = 0.15
    contrast_attention_min_weight: float = 1.0
    contrast_attention_max_weight: float = 3.0
    contrast_attention_blur_kernel: int = 7
    contrast_region_threshold: float = 0.15
    contrast_region_weight: float = 1.5
    contrast_region_pool: int = 8
    ssim_win_size: int = 11
    ssim_win_sigma: float = 1.5
    edge_topk_frac: float = 0.1


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
