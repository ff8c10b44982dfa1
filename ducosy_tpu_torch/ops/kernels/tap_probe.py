"""P3: the int8 / bf16 tap-matmul probe (scripts/probe_int8_mosaic.py:38).

``tap_matmul(a, b, taps)`` is the sum over ``taps`` of a @ b in one
accumulator, as the TPU probe computes it: int8 x int8 -> exact int32, or
bf16 x bf16 -> fp32. The kernel (``csrc/tap_probe.cu``) runs wgmma on
operands that each block loads once into shared memory, B transposed on its
way in: one launch a call for both dtypes. Its int8 and bf16 rates at the
trunk's tap shape, (16384, 256) x (256, 256) with 9 and 36 taps, answer the
TPU probe's question on the instruction K1q's conv2 runs. ``tap_plan`` is
the kernel's tile plan; ``probe`` reaches the kernel by parts, and the
original mma.sync / WMMA kernels, for measurement only.
``tap_matmul_plain`` is the exact product: float64 for int8 (every sum
below 2^53 is exact), fp32 for bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ducosy_tpu_torch.ops.kernels import _build

TILE_M = 128            # rows of a a block owns: two warpgroups of 64
WIDTH = 256             # N: all of b's columns in one block (m64n256 MMAs)
ROW_BYTES = 128         # bytes of K per operand row and chunk (one atom)
SMEM_MAX = 232448       # dynamic shared memory a block may use (sm_90)
SMEM_ALIGN = 1024       # the chunks start on a swizzle atom's period
PARTS = (1, 2, 3, 4, 7)  # probe: loads, MMAs, both, store; the whole
_SIZES = {torch.int8: 1, torch.bfloat16: 2}


class TapPlan(NamedTuple):
    """The kernel's geometry for one call (csrc/tap_probe.cu)."""
    blocks: int         # the grid: m / TILE_M
    chunk_k: int        # K elements a chunk (ROW_BYTES of them)
    chunks: int         # chunks of K, loaded once a block
    smem: int           # dynamic shared memory, bytes


def tap_plan(m: int, k: int, n: int, dtype: torch.dtype) -> TapPlan:
    """The tile plan of (m, k) x (k, n) in ``dtype``; raises for a shape or
    dtype the kernel does not take: both operands resident in one block's
    shared memory."""
    size = _SIZES.get(dtype)
    if size is None:
        raise TypeError(f"tap_probe kernel: dtype {dtype} (int8 or bfloat16)")
    chunk_k = ROW_BYTES // size
    smem = (TILE_M + WIDTH) * k * size + SMEM_ALIGN
    if (m <= 0 or m % TILE_M or n != WIDTH or k <= 0 or k % chunk_k
            or smem > SMEM_MAX):
        raise ValueError(
            f"tap_probe kernel: ({m}, {k}) x ({k}, {n}) {dtype}: M a positive "
            f"multiple of {TILE_M}, N = {WIDTH}, K a positive multiple of "
            f"{chunk_k}, and {TILE_M + WIDTH} K {size} + {SMEM_ALIGN} = "
            f"{smem} bytes of shared memory at most {SMEM_MAX}")
    return TapPlan(m // TILE_M, chunk_k, k // chunk_k, smem)


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
    for fn, ints in (("ducosy_tap_probe", 4), ("ducosy_tap_probe_parts", 5),
                     ("ducosy_tap_probe_original", 5)):
        getattr(dll, fn).restype = i
        getattr(dll, fn).argtypes = [p, p, p, *[i] * ints, p]
    return dll


def _checked(a: torch.Tensor, b: torch.Tensor, taps: int) -> tuple:
    """(m, k, n) of a CUDA call; raises for what the kernel does not take."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tap_probe kernel: operands on {a.device} and "
                         f"{b.device}; the kernel takes CUDA tensors")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"tap_probe kernel: dtypes {a.dtype}, {b.dtype} (both "
                        "int8 or both bfloat16)")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or taps < 1:
        raise ValueError(f"tap_probe kernel: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}, taps {taps}")
    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    tap_plan(m, k, n, a.dtype)
    return m, k, n


def _launch(fn: str, a, b, n: int, *ints):
    """The (m, n) out of entry point ``fn`` on a and b; ``ints`` are its
    int arguments."""
    out = a.new_empty((a.shape[0], n), dtype=torch.int32
                      if a.dtype == torch.int8 else torch.float32)
    a, b = a.contiguous(), b.contiguous()
    dll = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = getattr(dll, fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  *ints, stream)
    _build.check(dll, status, f"{fn} launch")
    return out


def tap_matmul(a: torch.Tensor, b: torch.Tensor, taps: int) -> torch.Tensor:
    """The sum over ``taps`` of a (M, K) @ b (K, N), both int8 or both bf16:
    the P3 kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return tap_matmul_plain(a, b, taps)
    m, k, n = _checked(a, b, taps)
    is_int8 = int(a.dtype == torch.int8)
    out = _launch("ducosy_tap_probe", a, b, n, m, k, taps, is_int8)
    tap_matmul.launches += 1
    return out


tap_matmul.launches = 0


def probe(a: torch.Tensor, b: torch.Tensor, taps: int, design: int,
          parts: int = 7) -> torch.Tensor:
    """P3 for measurement only (not counted), on CUDA tensors. ``design`` 1
    is the kernel by parts: 7 the whole, 1 the operands' loads, 2 the MMAs
    on the resident operands, 3 both, 4 the store (a part alone leaves the
    output meaningless). ``design`` 0 is the original mma.sync / WMMA
    kernels as the path ran them, int8's B transposed by a launch before
    the kernel (parts 7 only)."""
    m, k, n = _checked(a, b, taps)
    if design not in (0, 1) or parts not in PARTS or (design == 0
                                                      and parts != 7):
        raise ValueError(f"tap_probe probe: design {design} parts {parts} "
                         f"(design 1 parts {PARTS}; design 0 parts 7)")
    is_int8 = int(a.dtype == torch.int8)
    if design == 1:
        return _launch("ducosy_tap_probe_parts", a, b, n, m, k, taps,
                       is_int8, parts)
    return _launch("ducosy_tap_probe_original", a,
                   b.t().contiguous() if is_int8 else b, n, m, k, n, taps,
                   is_int8)
