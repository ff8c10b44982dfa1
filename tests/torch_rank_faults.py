"""Rank workers that inject a fault into the port's training loop, for the
spawned ranks of tests/test_torch_parallel.py. A spawned rank imports its
function by module path, so this module imports nothing of JAX or of the
JAX package (the test modules do)."""
import torch

from ducosy_tpu_torch.cli import train as tcli
from ducosy_tpu_torch.train import loop as tloop


def train_oom_once(device, args):
    """The training CLI's rank, where every step built without remat runs
    out of device memory before its optimizers start (as tests/
    test_torch_train.py's ``test_remat_auto_falls_back_on_oom`` does in one
    process)."""
    real = tloop.make_train_step

    def flaky(cfg, loss_cfg, *, remat, n_real=None, gen_forward=None,
              sp_devices=None):
        step = real(cfg, loss_cfg, remat=remat, n_real=n_real,
                    gen_forward=gen_forward, sp_devices=sp_devices)
        if remat:
            return step

        def oom(state, batch):
            raise torch.cuda.OutOfMemoryError("out of memory")
        oom.updating = False
        return oom

    tloop.make_train_step = flaky
    return tcli._train(device, args)
