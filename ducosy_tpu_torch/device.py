"""Device resolution for the port: CUDA by default, never a silent fallback."""
from __future__ import annotations

import torch


def require_cuda(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device`` and raise if it names CUDA while no card is visible.

    The serving entry points default to ``"cuda"``. A CPU device is honoured
    only when the caller names it (the CPU tests do); nothing here ever
    swaps one device for another."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return dev
