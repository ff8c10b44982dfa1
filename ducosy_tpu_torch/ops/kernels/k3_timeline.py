"""Where K3's launches spend their time, block by block, on the card.

    python -m ducosy_tpu_torch.ops.kernels.k3_timeline [n ...]

Builds a copy of ``csrc/instance_norm_bwd.cu`` whose sums and apply kernels
stamp ``%globaltimer`` and ``%smid`` from thread 0 of each block (the sums:
at its start, when every thread's stream loop is done, after its partials
and arrival, after the last block's merge; the apply: at its start and
end), runs K3 by parts on bf16 (n, 128, 128, 256), pad 1, ReLU (n = 8 by
default), and prints, per launch, when its blocks start, how long a block
streams (median, min, max), the tails, and each block's streaming time by
tile index, by sample and by SM. Measurement only: the stamped build is
used by this script and nothing else; the kernels' own sources are not
changed. Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import instance_norm as k2

MAX_BLOCKS = 1024
STAMPS = '''#include "tile_regs.cuh"
__device__ unsigned long long k3_tl[2][4][1024];
__device__ unsigned k3_sm[2][1024];
#define STAMP(k, e)                                                     \\
  if (threadIdx.x == 0) {                                               \\
    const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;            \\
    unsigned long long t_;                                              \\
    unsigned s_;                                                        \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \\
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s_));                     \\
    k3_tl[k][e][b_] = t_;                                               \\
    k3_sm[k][b_] = s_;                                                  \\
  }
extern "C" int k3_timeline(unsigned long long* t, unsigned* sm) {
  const cudaError_t e = cudaMemcpyFromSymbol(t, k3_tl, sizeof(k3_tl));
  return e != cudaSuccess ? (int)e
                          : (int)cudaMemcpyFromSymbol(sm, k3_sm, sizeof(k3_sm));
}
'''
# (anchor in the source, text put in its place); each anchor occurs once
PATCHES = (
    ('#include "tile_regs.cuh"\n', STAMPS),
    ("  pdl_trigger();     // the apply's blocks may take the SMs this grid "
     "frees\n  const int t = blockIdx.x, ni = blockIdx.y, hw = h * w, m0 = t "
     "* tile;\n  const int npx = min(tile, hw - m0), lds = c + 1;\n",
     "  pdl_trigger();\n  STAMP(0, 0);\n  const int t = blockIdx.x, ni = "
     "blockIdx.y, hw = h * w, m0 = t * tile;\n  const int npx = min(tile, hw "
     "- m0), lds = c + 1;\n"),
    ("  __syncthreads();   // the ring is free: the per-row sums take its "
     "place\n", "  __syncthreads();\n  STAMP(0, 1);\n"),
    ("  if (!last) return;\n", "  STAMP(0, 2);\n  if (!last) return;\n"),
    ("    gmgy[(size_t)ni * c + ch] = b / (float)hw;\n  }\n}\n",
     "    gmgy[(size_t)ni * c + ch] = b / (float)hw;\n  }\n  __syncthreads();\n"
     "  STAMP(0, 3);\n}\n"),
    ("  extern __shared__ __align__(16) uint4 ring[];\n  pdl_trigger();\n",
     "  extern __shared__ __align__(16) uint4 ring[];\n  pdl_trigger();\n"
     "  STAMP(1, 0);\n"),
    ("  if (!ln.active()) return;\n  const int ch0 = ln.lane * V;\n  T* ds",
     "  if (!ln.active()) {\n    __syncthreads();\n    STAMP(1, 1);\n    "
     "return;\n  }\n  const int ch0 = ln.lane * V;\n  T* ds"),
    ("Io<T>::pack(v));\n      });\n}\n",
     "Io<T>::pack(v));\n      });\n  __syncthreads();\n  STAMP(1, 1);\n}\n"),
)


def build_stamped() -> ctypes.CDLL:
    """The stamped copy of instance_norm_bwd.cu, built with the kernels'
    own flags into _build/k3_timeline/, with K3's ctypes declarations."""
    out = _build.BUILD_DIR / "k3_timeline"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    src = out / "instance_norm_bwd.cu"
    text = src.read_text()
    for anchor, new in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"k3_timeline: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    src.write_text(text)
    lib = out / "libk3_timeline.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    real = _build.load_library
    _build.load_library = lambda name: ctypes.CDLL(str(lib))
    try:
        dll = k2._bwd_lib.__wrapped__()
    finally:
        _build.load_library = real
    dll.ducosy_error_string.restype = ctypes.c_char_p
    dll.ducosy_error_string.argtypes = [ctypes.c_int]
    dll.k3_timeline.restype = ctypes.c_int
    dll.k3_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return dll


def report(dll, n: int) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn((n, 128, 128, 256), generator=gen, device=dev)
         + 0.5).to(torch.bfloat16)
    g = torch.randn((n, 130, 130, 256), generator=gen, device=dev) \
        .to(torch.bfloat16)
    nb = k2.device_plan(x).tiles * n
    if nb > MAX_BLOCKS:
        raise ValueError(f"k3_timeline: {nb} blocks, stamps hold {MAX_BLOCKS}")
    t = np.zeros((2, 4, MAX_BLOCKS), dtype=np.uint64)
    sm = np.zeros((2, MAX_BLOCKS), dtype=np.uint32)
    us = lambda v: v / 1000.0
    for label, parts in (("sums alone", 2), ("apply alone", 4), ("whole", 7)):
        for _ in range(3):
            k2.probe_bwd(x, g, 1, parts)
        torch.cuda.synchronize()
        status = dll.k3_timeline(t.ctypes.data, sm.ctypes.data)
        if status:
            raise RuntimeError(f"k3_timeline: CUDA error {status}")
        st = t.astype(np.int64)[:, :, :nb]
        for k, name in ((0, "sums"), (1, "apply")):
            if not parts & (2 << k):
                continue
            t0 = st[0, 0].min() if parts & 2 else st[k, 0].min()
            run = us(st[k, 1] - st[k, 0])
            line = (f"n={n} {label}, {name}: blocks start "
                    f"{us(st[k, 0].min() - t0):.1f}..{us(st[k, 0].max() - t0):.1f}"
                    f" us; a block streams {np.median(run):.1f} us median "
                    f"(min {run.min():.1f}, max {run.max():.1f}); the last "
                    f"stream ends at {us(st[k, 1].max() - t0):.1f} us")
            if k == 0:
                line += (f"; partials and arrival "
                         f"{np.median(us(st[0, 2] - st[0, 1])):.1f} us median;"
                         f" the last merge ends at "
                         f"{us(st[0, 3].max() - t0):.1f} us")
            print(line, flush=True)
            if parts == 2 << k:
                per = run.reshape(n, nb // n)
                print("   by tile index (mean over samples): "
                      + " ".join(f"{v:.0f}" for v in per.mean(axis=0)))
                print("   by sample (mean over tiles): "
                      + " ".join(f"{v:.0f}" for v in per.mean(axis=1)))
                order = np.argsort(sm[k, :nb], kind="stable")
                print("   by SM (id:us): " + " ".join(
                    f"{int(sm[k, i])}:{run[i]:.0f}" for i in order),
                    flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k3_timeline: needs a CUDA card")
    dll = build_stamped()
    k2._bwd_lib = lambda: dll        # this process only: the stamped build
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for n in [int(a) for a in argv] or [8]:
        report(dll, n)


if __name__ == "__main__":
    main()
