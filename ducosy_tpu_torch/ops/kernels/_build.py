"""Build ``ducosy_tpu_torch/csrc/*.cu`` with nvcc at first use; load with ctypes.

Each source becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries land in
``ducosy_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags so an edited source is never served by a stale build. The
compiler's output, including ``-Xptxas -v``'s register and spill report, is
kept beside each library as ``<name>.log``. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME`` (as torch resolves it) or ``$PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for the current sources."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a unless already built; returns
    the library's path. Raises RuntimeError if nvcc fails."""
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                            ".tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                f"{proc.stderr[-6000:]}")
        os.replace(tmp, lib)
    return lib


def build_all(names) -> None:
    """Build several sources at once, one nvcc process each; raises the
    first failure after all have finished."""
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it. Cached per process;
    raises RuntimeError if nvcc fails."""
    dll = ctypes.CDLL(str(build(name)))
    dll.ducosy_error_string.restype = ctypes.c_char_p
    dll.ducosy_error_string.argtypes = [ctypes.c_int]
    return dll


def build_log(name: str) -> str:
    """The compiler output kept with the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def check(dll: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (each entry
    point returns ``cudaGetLastError()`` after its launches)."""
    if status != 0:
        msg = dll.ducosy_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
