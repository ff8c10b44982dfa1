"""Training CLI (cli/train.py; reference train.py:16-49).

    python -m ducosy_tpu_torch.cli.train --data_root DIR --dataset_names NAME

Trains the soft-tissue and/or lung CycleGAN with the fixed per-range HU,
window and mask settings. Same flags as the JAX CLI, plus ``--device``
(default ``cuda``; the run raises if no card is visible, ``--device cpu``
runs the plain PyTorch path), ``--trunk`` (``tail``, the K2-K5 kernels, or
``plain``), ``--remat``, ``--max_steps_per_epoch`` and the widths
``--base_channels`` / ``--disc_base_channels``.

``--num_devices N`` trains data-parallel on the first N cards, one rank a
card over NCCL (default: every visible card, as the JAX CLI's mesh; 1 with
``--device cpu``, where N > 1 runs N gloo ranks on the CPU); more cards
than are visible raises. ``--batch_size`` is the global batch and must
divide by N. Under torchrun (``WORLD_SIZE`` > 1 in the environment) each
process is one rank on ``cuda:LOCAL_RANK``: the multi-host form. Rank 0
writes the run's files; ``main`` returns its summary.
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
                   help="cards to train on, one rank a card (default: every "
                        "visible card; 1 with --device cpu)")
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


def _devices(args, device: torch.device) -> tuple:
    """The ranks' devices: ``--num_devices`` cards (a card named with its
    index, alone), or N CPU ranks."""
    from ducosy_tpu_torch.parallel.mesh import data_mesh

    n = args.num_devices
    if device.type == "cpu":
        return data_mesh(devices=[device] * (n or 1))
    if device.index is not None and n in (None, 1):
        return (device,)
    return data_mesh(n)


def _train(device: torch.device, args) -> dict:
    """Train the selected ranges on ``device``: the whole run, or one rank
    of it; returns {target: summary}."""
    from ducosy_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ducosy_tpu_torch.parallel.mesh import rank
    from ducosy_tpu_torch.train.loop import train_cycle_gan

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
    say = print if rank() == 0 else (lambda *a, **k: None)
    out = {}
    for target in targets:
        say(f"=== training {target} CycleGAN ===")
        out[target] = train_cycle_gan(
            cfg, target, model_cfg, device=device, trunk=args.trunk,
            max_epochs=args.max_epochs,
            max_steps_per_epoch=args.max_steps_per_epoch)
        say(f"=== {target} done: val_loss={out[target]['val_loss']} "
            f"remat={out[target]['remat']} ===")
    return out


def main(argv=None):
    """Run the CLI; returns {target: summary} of the trained ranges (rank
    0's in a data-parallel run)."""
    args = parse_args(argv)
    from ducosy_tpu_torch.device import require_cuda
    from ducosy_tpu_torch.parallel import launch
    from ducosy_tpu_torch.parallel.mesh import init_distributed

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:   # one rank of a torchrun launch
        if args.num_devices not in (None, world):
            raise ValueError(f"--num_devices {args.num_devices} under a "
                             f"torchrun launch of {world} ranks")
        device = init_distributed(require_cuda(args.device).type)
        return _train(device, args)
    devices = _devices(args, require_cuda(args.device))
    if len(devices) == 1:
        return _train(devices[0], args)
    return launch.spawn(_train, (args,), devices)[0]


if __name__ == "__main__":
    main()
