"""The card a run uses: its presence, its line, its clocks, and the caches
kept inside the checkout.

``gpu_line`` and ``gpu_state`` are the port's smoke script's: nvidia-smi's
name and power limit, and the SM clock and power draw at the moment they
are read (sampled beside the measured window, never inside it).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# top-level module names no process of the benchmark may hold: the JAX
# package and JAX itself (compared whole: the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ducosy_tpu")


class NoCard(RuntimeError):
    pass


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds. The port builds its kernels
    into its own ``_build/`` (inside the checkout already); these are for
    anything else that would cache."""
    cache = Path(root) / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def require_card(chips: int):
    """The CUDA device count, or NoCard: never a fallback to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "runs on a CUDA card only")
    count = torch.cuda.device_count()
    if count < chips:
        raise NoCard(f"{count} CUDA devices, the cell asks for {chips}")
    return count


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return _smi("name,power.limit")


def gpu_state() -> str:
    return _smi("clocks.sm,power.draw")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
