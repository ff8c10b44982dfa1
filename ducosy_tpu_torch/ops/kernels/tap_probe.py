"""P3: the int8 tap-matmul probe (scripts/probe_int8_mosaic.py:38).

``tap_matmul(a, b, taps)`` is taps * (a @ b), computed by running the
product ``taps`` times into one accumulator: int8 x int8 -> exact int32,
or bf16 x bf16 -> fp32. The kernels (``csrc/tap_probe.cu``) are the main
loops of K1's int8 and bf16 convs, so their rates at the trunk's tap shape,
(16384, 256) x (256, 256) with 9 and 36 taps, tell whether K1q's int8
conv2 pays on the card. ``tap_matmul_plain`` is the exact product: float64
for int8 (every sum below 2^53 is exact), fp32 for bf16.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ducosy_tpu_torch.ops.kernels import _build

TILE_M, TILE_N, TILE_K = 128, 64, 64   # csrc/tap_probe.cu


def tap_matmul_plain(a: torch.Tensor, b: torch.Tensor, taps: int):
    """taps * (a @ b): int32 for int8 operands (exact), fp32 for bf16."""
    if a.dtype == torch.int8:
        return (torch.round(a.to(torch.float64) @ b.to(torch.float64))
                * taps).to(torch.int32)
    return (a.to(torch.float32) @ b.to(torch.float32)) * taps


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = _build.load_library("tap_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ducosy_tap_probe.restype = i
    dll.ducosy_tap_probe.argtypes = [p, p, p, i, i, i, i, i, p]
    return dll


def tap_matmul(a: torch.Tensor, b: torch.Tensor, taps: int) -> torch.Tensor:
    """taps * (a (M, K) @ b (K, N)), both int8 or both bf16: the P3 kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return tap_matmul_plain(a, b, taps)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tap_probe kernel: operands on {a.device} and "
                         f"{b.device}; the kernel takes CUDA tensors")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"tap_probe kernel: dtypes {a.dtype}, {b.dtype} (both "
                        "int8 or both bfloat16)")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or m % TILE_M or n % TILE_N or k % TILE_K or taps < 1:
        raise ValueError(f"tap_probe kernel: ({m}, {k}) x ({k2}, {n}), taps "
                         f"{taps} (M a multiple of {TILE_M}, N of {TILE_N}, "
                         f"K of {TILE_K})")
    is_int8 = a.dtype == torch.int8
    a = a.contiguous()
    b = b.t().contiguous() if is_int8 else b.contiguous()
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.int32 if is_int8 else torch.float32)
    dll = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = dll.ducosy_tap_probe(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), m, k, n, taps,
                                      int(is_int8), stream)
    _build.check(dll, status, "tap_probe kernel launch")
    tap_matmul.launches += 1
    return out


tap_matmul.launches = 0
