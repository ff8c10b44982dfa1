"""The learning-rate schedule (ducosy_tpu/train/schedule.py).

The reference steps three LambdaLR schedulers once per epoch with
  factor(epoch) = 1 - max(0, epoch + 1 - decay_epoch) / (epochs - decay_epoch)
(modules/trainer.py:364-367): constant until decay_epoch, then linear decay
to 0 at the last epoch. The loop sets the resulting lr once per epoch.
"""
from __future__ import annotations


def linear_decay_factor(epoch: int, epochs: int, decay_epoch: int) -> float:
    denom = max(epochs - decay_epoch, 1)
    return 1.0 - max(0, epoch + 1 - decay_epoch) / denom


def lr_for_epoch(base_lr: float, epoch: int, epochs: int,
                 decay_epoch: int) -> float:
    return base_lr * linear_decay_factor(epoch, epochs, decay_epoch)
