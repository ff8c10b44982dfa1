"""Training CLI on one CUDA card (cli/train.py; reference train.py:16-49).

    python -m ducosy_tpu_torch.cli.train --data_root DIR --dataset_names NAME

Trains the soft-tissue and/or lung CycleGAN with the fixed per-range HU,
window and mask settings. Same flags as the JAX CLI, plus ``--device``
(default ``cuda``; the run raises if no card is visible, ``--device cpu``
runs the plain PyTorch path), ``--trunk`` (``tail``, the K2-K5 kernels, or
``plain``), ``--remat``, ``--max_steps_per_epoch`` and the widths
``--base_channels`` / ``--disc_base_channels``. ``--num_devices``
other than 1 raises: multi-card training is not ported yet.
"""
from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DuCoSy-GAN training (PyTorch)")
    p.add_argument("--target_model", type=str, default="soft_tissue",
                   choices=["soft_tissue", "lung", "all"])
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--decay_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lambda_cyc", type=float, default=10.0)
    p.add_argument("--lambda_id", type=float, default=5.0)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--training_dir", type=str, default="./training_dir")
    p.add_argument("--data_root", type=str, default="./data/train")
    p.add_argument("--dataset_names", type=str, default="")
    p.add_argument("--ncct_folder", type=str, default="POST VUE")
    p.add_argument("--cect_folder", type=str, default="POST STD")
    p.add_argument("--resume", type=str, default="checkpoint",
                   help="checkpoint name under saved_models ('' = fresh)")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=None,
                   help="multi-card training (not ported yet)")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="cap epochs this invocation (resume continues)")
    p.add_argument("--num_residual_blocks", type=int, default=9)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of a few early steps")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--trunk", type=str, default="tail",
                   choices=["tail", "plain"])
    p.add_argument("--remat", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--base_channels", type=int, default=64)
    p.add_argument("--disc_base_channels", type=int, default=64)
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns {target: summary} of the trained ranges."""
    args = parse_args(argv)
    if args.num_devices not in (None, 1):
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: multi-card training is not "
            "ported yet (one card)")
    from ducosy_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ducosy_tpu_torch.device import require_cuda
    from ducosy_tpu_torch.train.loop import train_cycle_gan

    device = require_cuda(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # fixed shapes every step
    cfg = replace(
        TrainConfig(),
        epochs=args.epochs, decay_epoch=args.decay_epoch,
        batch_size=args.batch_size, lr=args.lr,
        lambda_cyc=args.lambda_cyc, lambda_id=args.lambda_id,
        num_workers=args.num_workers, training_dir=args.training_dir,
        data_root=args.data_root, dataset_names=args.dataset_names,
        ncct_folder=args.ncct_folder, cect_folder=args.cect_folder,
        resume=args.resume, img_size=args.img_size,
        val_split=args.val_split, compute_dtype=args.compute_dtype,
        profile_dir=args.profile_dir, remat=args.remat)
    model_cfg = ModelConfig(num_residual_blocks=args.num_residual_blocks,
                            base_channels=args.base_channels,
                            disc_base_channels=args.disc_base_channels)
    os.makedirs(cfg.training_dir, exist_ok=True)
    targets = ["soft_tissue", "lung"] if args.target_model == "all" \
        else [args.target_model]
    out = {}
    for target in targets:
        print(f"=== training {target} CycleGAN ===")
        out[target] = train_cycle_gan(
            cfg, target, model_cfg, device=device, trunk=args.trunk,
            max_epochs=args.max_epochs,
            max_steps_per_epoch=args.max_steps_per_epoch)
        print(f"=== {target} done: val_loss={out[target]['val_loss']} "
              f"remat={out[target]['remat']} ===")
    return out


if __name__ == "__main__":
    main()
