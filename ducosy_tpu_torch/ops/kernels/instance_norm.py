"""K2: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC tensor.

Replaces ``instance_norm_pallas`` (ducosy_tpu/ops/pallas/instance_norm.py:
206, forward with ``relu`` and ``pad``). On the serving path it normalizes
down1 (N, 256, 256, 128) and down2 (N, 128, 128, 256); the down2 call also
writes the trunk's first reflect pad, giving (N, 130, 130, 256).

The kernel (``csrc/instance_norm.cu``) is CUDA C++ and shares its
statistics and apply code with K1. ``instance_norm_plain`` is the same
function in plain PyTorch: the TPU package's XLA composition (fp32 centred
statistics, eps 1e-5, no affine).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ducosy_tpu_torch.models.layers import (
    EPS_INSTANCE_NORM,
    instance_norm as _instance_norm,
    reflect_pad,
)
from ducosy_tpu_torch.ops.kernels import _build

TILE_M = 128   # pixels per statistics tile (csrc/common.cuh)
TILE_N = 64    # channels per tile; C must be a multiple


def instance_norm_plain(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                        eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """Plain PyTorch K2: IN (fp32 stats), optional ReLU, reflect pad."""
    y = _instance_norm(x, eps)
    if relu:
        y = torch.relu(y)
    return reflect_pad(y, pad)


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("instance_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_instance_norm.restype = i
    dll.ducosy_instance_norm.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         ctypes.c_float, i, p]
    return dll


def _validate(x: torch.Tensor, pad: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm kernel: tensor on {x.device}; the "
                         "kernel takes CUDA tensors (CPU runs the plain path)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm kernel: dtype {x.dtype} (float32 or "
                        "bfloat16 only)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("instance_norm kernel: needs a contiguous NHWC tensor")
    n, h, w, c = x.shape
    if c % TILE_N or c == 0:
        raise ValueError(f"instance_norm kernel: C={c} must be a positive "
                         f"multiple of {TILE_N}")
    if pad not in (0, 1) or (pad and min(h, w) < 2):
        raise ValueError(f"instance_norm kernel: pad={pad} on {h}x{w} "
                         "(pad 0 or 1, reflect needs H, W >= 2)")


def instance_norm(x: torch.Tensor, *, relu: bool = False, pad: int = 0,
                  eps: float = EPS_INSTANCE_NORM) -> torch.Tensor:
    """IN(+ReLU) of an NHWC tensor, reflect-padded by ``pad``: the K2 kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu=relu, pad=pad, eps=eps)
    _validate(x, pad)
    n, h, w, c = x.shape
    tiles = -(-h * w // TILE_M)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                      device=x.device)
    pmean = torch.empty((n, tiles, c), **f32)
    pm2 = torch.empty((n, tiles, c), **f32)
    mean = torch.empty((n, c), **f32)
    rstd = torch.empty((n, c), **f32)
    dll = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = dll.ducosy_instance_norm(
            x.data_ptr(), out.data_ptr(), pmean.data_ptr(), pm2.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, h, w, c, int(relu), pad,
            float(eps), int(x.dtype == torch.bfloat16), stream)
    _build.check(dll, status, "instance_norm kernel launch")
    instance_norm.launches += 1
    return out


instance_norm.launches = 0
