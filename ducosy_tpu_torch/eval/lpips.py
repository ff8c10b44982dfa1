"""LPIPS (Learned Perceptual Image Patch Similarity), AlexNet backbone, as
a torch module in NCHW (ducosy_tpu/eval/lpips.py).

The ``lpips`` package's default configuration (``lpips.LPIPS(net='alex')``)
that the reference evaluation suite runs (calculate.py:293-318): inputs in
[-1, 1], the ImageNet shift/scale, the torchvision AlexNet ``features``
trunk (five convs, 3x3 stride-2 max-pools before stages 2 and 3), feature
differences of channel-unit-normalized activations squared, 1x1
non-negative linear heads, the spatial mean, summed over the five stages.

Pretrained weights cannot ship offline, so the network is driven by a
weights file: :func:`load_lpips_weights` reads either

  * a torch checkpoint (``.pth``/``.pt``) holding the torchvision AlexNet
    keys (``features.0.weight`` ...) and the lpips heads
    (``lin0.model.1.weight`` ...), i.e. ``alexnet(...).state_dict()`` and
    ``lpips/weights/v0.1/alex.pth`` together; or
  * an ``.npz`` with the same key names (``save_lpips_weights_npz``).

Without a weights file callers return NaN, as the reference does when its
``lpips`` import fails (calculate.py:33-41). The convolutions run in true
fp32 (TF32 off for their duration), as the JAX package's run at
``Precision.HIGHEST``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet `features` trunk: (layer key, out_ch, kernel, stride,
# pad) of the conv layers; lpips taps each one's ReLU
_CONVS = (
    ("features.0", 64, 11, 4, 2),
    ("features.3", 192, 5, 1, 2),
    ("features.6", 384, 3, 1, 1),
    ("features.8", 256, 3, 1, 1),
    ("features.10", 256, 3, 1, 1),
)
# max-pool (3x3 stride 2) sits before conv stages 2 and 3
_POOL_BEFORE = (False, True, True, False, False)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ENV_WEIGHTS = "DUCOSY_LPIPS_WEIGHTS"


def default_weights_path() -> str | None:
    """Weights file from $DUCOSY_LPIPS_WEIGHTS or the conventional
    checkpoints/lpips_alex.{npz,pth} locations; None when absent."""
    cand = [os.environ.get(ENV_WEIGHTS, "")]
    cand += ["checkpoints/lpips_alex.npz", "checkpoints/lpips_alex.pth"]
    for c in cand:
        if c and os.path.isfile(c):
            return c
    return None


def load_lpips_weights(path: str) -> Dict[str, np.ndarray]:
    """Load and check LPIPS-AlexNet weights into the canonical dict: conv
    kernels in torch's OIHW as ``conv{i}_w``, biases ``conv{i}_b`` and the
    per-stage head vectors ``lin{i}`` of shape (C,), all fp32."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: np.asarray(data[k]) for k in data.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):  # a full module was saved
            sd = sd.state_dict()
        raw = {k: v.detach().cpu().numpy() for k, v in sd.items()}

    params: Dict[str, np.ndarray] = {}
    for i, (key, out_ch, k, _, _) in enumerate(_CONVS):
        w = raw.get(f"{key}.weight")
        b = raw.get(f"{key}.bias")
        if w is None or b is None:
            raise ValueError(f"LPIPS weights at {path} missing {key}.*")
        if w.shape != (out_ch, w.shape[1], k, k):
            raise ValueError(f"{key}.weight has shape {w.shape}")
        params[f"conv{i}_w"] = w.astype(np.float32)
        params[f"conv{i}_b"] = b.astype(np.float32)
    for i, (_, out_ch, _, _, _) in enumerate(_CONVS):
        lin = raw.get(f"lin{i}.model.1.weight",
                      raw.get(f"lins.{i}.model.1.weight",
                              raw.get(f"lin{i}")))
        if lin is None:
            raise ValueError(f"LPIPS weights at {path} missing lin{i}")
        params[f"lin{i}"] = np.asarray(lin, np.float32).reshape(-1)
        if params[f"lin{i}"].shape != (out_ch,):
            raise ValueError(f"lin{i} has {params[f'lin{i}'].shape} weights, "
                             f"expected ({out_ch},)")
    return params


def save_lpips_weights_npz(params: Dict[str, np.ndarray], path: str) -> None:
    """Write canonical weights as a portable .npz under the .pth key names
    (the JAX package's loader reads it too)."""
    flat = {}
    for i, (key, _, _, _, _) in enumerate(_CONVS):
        flat[f"{key}.weight"] = params[f"conv{i}_w"]
        flat[f"{key}.bias"] = params[f"conv{i}_b"]
        flat[f"lin{i}"] = params[f"lin{i}"]
    np.savez(path, **flat)


@contextlib.contextmanager
def _true_fp32():
    """cuDNN convolutions without TF32 inside the block (the process's
    setting is restored after)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class LPIPSAlex(torch.nn.Module):
    """LPIPS(AlexNet) from a weights file. ``forward(x0, x1)`` takes
    (N, 1, H, W) or (N, 3, H, W) images in [-1, 1] and returns the (N,)
    distances; ``distance`` scores two (Z, H, W) volumes with the
    reference's semantics (calculate.py:296-312)."""

    def __init__(self, weights_path: str):
        super().__init__()
        params = load_lpips_weights(weights_path)
        for name, value in params.items():
            self.register_buffer(name, torch.from_numpy(value))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def _stages(self, x):
        h = (x.expand(-1, 3, -1, -1) - self.shift) / self.scale
        feats = []
        for i, (_, _, _, stride, pad) in enumerate(_CONVS):
            if _POOL_BEFORE[i]:
                h = F.max_pool2d(h, 3, stride=2)
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), stride=stride,
                                padding=pad))
            feats.append(h)
        return feats

    def forward(self, x0, x1):
        total = 0.0
        with _true_fp32():
            f0, f1 = self._stages(x0), self._stages(x1)
        for i, (a, b) in enumerate(zip(f0, f1)):
            na = a / (a.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            nb = b / (b.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            d = (na - nb).pow(2)
            head = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            # 1x1 head, then the spatial mean (lpips spatial=False)
            total = total + (d * head).sum(1).mean(dim=(1, 2))
        return total

    def distance(self, img1: np.ndarray, img2: np.ndarray,
                 batch: int = 32) -> tuple[float, list[float]]:
        """Per-slice LPIPS of two (Z, H, W) volumes: each volume min-max
        normalized to [0, 1] as a whole, mapped to [-1, 1], grey replicated
        to RGB; (mean, per-slice list)."""
        dev = self.shift.device

        def norm(v):
            v = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            v = (v - v.min()) / (v.max() - v.min() + 1e-8)
            return v * 2.0 - 1.0

        dists: list[float] = []
        with torch.inference_mode():
            a, b = norm(img1), norm(img2)
            for s in range(0, len(a), batch):
                d = self(a[s:s + batch, None], b[s:s + batch, None])
                dists += [float(v) for v in d.cpu().numpy()]
        return float(np.mean(dists)), dists
