"""3-D U-Net HU difference-map predictor (the "nmodel"), in PyTorch.

The port of ducosy_tpu/models/unet3d.py, itself the rebuild of the
reference's modules/nmodel/model.py:7-163. NCDHW as the reference, with
its module tree, so the reference's ``.pth`` loads strictly
(``num_batches_tracked`` included):

  inc.double_conv.{0,1,3,4}                 DoubleConv (conv, BN, ReLU) x 2
  down{i}.maxpool_conv.1.double_conv.*      MaxPool (1, 2, 2), DoubleConv
  up{i}.conv.double_conv.*                  upsample, pad, concat, DoubleConv
  outc.conv.{weight,bias}                   1x1x1 conv

  UNet3D      4 down stages, base 32 channels (reference :80-122)
  UNet3DLight 3 down stages, base 16 channels (reference :125-163)

Depth is never pooled or upsampled. The upsample is align-corners linear on
H and W (a size-1 axis repeats), then the centre pad to the skip and the
concat ``[skip, up]``. BatchNorm is the JAX package's flax
``BatchNorm(momentum=0.9, epsilon=1e-5)``: it normalizes with the batch's
biased variance and updates the running variance with that same biased
variance, where ``nn.BatchNorm3d`` would update it with the unbiased one.
The convs are ``F.conv3d`` (cuDNN on the card), as the JAX package's are
``flax.linen.Conv`` outside any kernel.

HU normalization contract (modules/nmodel/dataset.py:169-208), on numpy
arrays and torch tensors alike:
  normalize_hu:  clip [-1024, 3071] -> [-1, 1]
  normalize_diff / denormalize_diff: clip [0, 4000] <-> [-1, 1]
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ducosy_tpu_torch.device import require_cuda

HU_MIN, HU_MAX = -1024.0, 3071.0
DIFF_MIN, DIFF_MAX = 0.0, 4000.0
BN_MOMENTUM = 0.9      # flax convention: running = m * running + (1-m) * batch
BN_EPS = 1e-5


def normalize_hu(volume, min_hu=HU_MIN, max_hu=HU_MAX):
    volume = volume.clip(min_hu, max_hu)
    return (volume - min_hu) / (max_hu - min_hu) * 2.0 - 1.0


def denormalize_hu(volume, min_hu=HU_MIN, max_hu=HU_MAX):
    return (volume + 1.0) / 2.0 * (max_hu - min_hu) + min_hu


def normalize_diff(diff, min_diff=DIFF_MIN, max_diff=DIFF_MAX):
    diff = diff.clip(min_diff, max_diff)
    return (diff - min_diff) / (max_diff - min_diff) * 2.0 - 1.0


def denormalize_diff(diff, min_diff=DIFF_MIN, max_diff=DIFF_MAX):
    return (diff + 1.0) / 2.0 * (max_diff - min_diff) + min_diff


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d``'s parameters and buffers with flax's running
    statistics: in training the batch normalizes with its biased variance
    (as ``F.batch_norm``) and the running mean and variance move towards
    the batch's mean and biased variance by 1 - BN_MOMENTUM."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3, 4),
                                       correction=0)
            self.running_mean.lerp_(mean, 1 - BN_MOMENTUM)
            self.running_var.lerp_(var, 1 - BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y


class DoubleConv(nn.Module):
    """(Conv3d -> BN -> ReLU) x 2 (reference DoubleConv, :7-24)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv3d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm(mid), nn.ReLU(inplace=True),
            nn.Conv3d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    """Spatial-only maxpool (1, 2, 2) + DoubleConv (reference Down, :27-39)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool3d((1, 2, 2)), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Spatial x2 upsample, centre pad to the skip, concat [skip, up],
    DoubleConv (reference Up, :42-68, trilinear variant)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, mid_channels)

    def forward(self, x1, x2):
        # align_corners linear on H and W; depth keeps its size (scale 1)
        x1 = F.interpolate(x1, scale_factor=(1, 2, 2), mode="trilinear",
                           align_corners=True)
        pads = []
        for axis in (4, 3, 2):                       # W, H, D: F.pad order
            diff = x2.shape[axis] - x1.shape[axis]
            pads += [diff // 2, diff - diff // 2]
        x1 = F.pad(x1, pads)
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.conv(x)


class UNet3D(nn.Module):
    """Standard 4-down 3-D U-Net (reference UNet3D, :80-122)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 base_channels: int = 32):
        super().__init__()
        c = base_channels
        self.inc = DoubleConv(n_channels, c)
        self.down1 = Down(c, c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.down3 = Down(c * 4, c * 8)
        self.down4 = Down(c * 8, c * 8)
        self.up1 = Up(c * 16, c * 4, c * 8)
        self.up2 = Up(c * 8, c * 2, c * 4)
        self.up3 = Up(c * 4, c, c * 2)
        self.up4 = Up(c * 2, c, c)
        self.outc = OutConv(c, n_classes)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x)


class UNet3DLight(nn.Module):
    """3-down memory-light variant (reference UNet3DLight, :125-163)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 base_channels: int = 16):
        super().__init__()
        c = base_channels
        self.inc = DoubleConv(n_channels, c)
        self.down1 = Down(c, c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.down3 = Down(c * 4, c * 4)
        self.up1 = Up(c * 8, c * 2, c * 4)
        self.up2 = Up(c * 4, c, c * 2)
        self.up3 = Up(c * 2, c, c)
        self.outc = OutConv(c, n_classes)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x = self.up1(x4, x3)
        x = self.up2(x, x2)
        x = self.up3(x, x1)
        return self.outc(x)


def predict_volume(model: nn.Module, vue_volume: np.ndarray, *,
                   slice_batch: int = 8,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """HU volume (D, H, W) -> predicted HU difference map
    (modules/nmodel/inference.py:65-82): normalize, run the net in eval mode
    over chunks of ``slice_batch`` depth-1 volumes (the reference's
    (1, 512, 512) patch shape; the last chunk padded with zeros), and
    denormalize. Runs on ``device`` (the card unless the caller names the
    CPU) and moves ``model`` there."""
    dev = require_cuda(device)
    d, h, w = vue_volume.shape
    model = model.to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            v = normalize_hu(torch.as_tensor(np.asarray(vue_volume),
                                             device=dev).float())
            pad = (-d) % slice_batch
            if pad:
                v = torch.cat([v, v.new_zeros((pad, h, w))])
            outs = [model(chunk[:, None, None])
                    for chunk in v.split(slice_batch)]
            out = torch.cat(outs).reshape(-1, h, w)[:d]
            return denormalize_diff(out).cpu().numpy()
    finally:
        model.train(was_training)


# ------------------------------------------------- weights across packages
def unet3d_state_dict_from_variables(params, batch_stats) -> dict:
    """The JAX package's variables (nested dicts of numpy arrays, flax
    layout: conv kernels (D, H, W, I, O)) -> this module's state dict in
    the reference's layout. The inverse of the JAX package's
    ``unet3d_params_from_torch``; ``num_batches_tracked`` is 0."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv3(k):
        return t(np.asarray(k).transpose(4, 3, 0, 1, 2))

    def double_conv(p, s, prefix):
        for i, idx in enumerate((0, 3)):
            bn = f"bn{i + 1}"
            sd[f"{prefix}.{idx}.weight"] = conv3(p[f"conv{i + 1}"]["kernel"])
            sd[f"{prefix}.{idx + 1}.weight"] = t(p[bn]["scale"])
            sd[f"{prefix}.{idx + 1}.bias"] = t(p[bn]["bias"])
            sd[f"{prefix}.{idx + 1}.running_mean"] = t(s[bn]["mean"])
            sd[f"{prefix}.{idx + 1}.running_var"] = t(s[bn]["var"])
            sd[f"{prefix}.{idx + 1}.num_batches_tracked"] = torch.tensor(0)

    double_conv(params["inc"], batch_stats["inc"], "inc.double_conv")
    n_down = 4 if "down4" in params else 3
    for i in range(1, n_down + 1):
        double_conv(params[f"down{i}"]["conv"], batch_stats[f"down{i}"]["conv"],
                    f"down{i}.maxpool_conv.1.double_conv")
        double_conv(params[f"up{i}"]["conv"], batch_stats[f"up{i}"]["conv"],
                    f"up{i}.conv.double_conv")
    sd["outc.conv.weight"] = conv3(params["outc"]["kernel"])
    sd["outc.conv.bias"] = t(params["outc"]["bias"])
    return sd


def load_model(checkpoint_path: str,
               device: str | torch.device = "cuda") -> nn.Module:
    """Reference-compatible loader (inference.py:17-62): the class from
    whether ``down4`` is present, the base width and input channels from
    the ``inc`` weight's shape, a ``model_state_dict`` wrapper accepted;
    loads strictly and returns the module in eval mode on ``device`` (the
    card unless the caller names the CPU)."""
    dev = require_cuda(device)
    ckpt = torch.load(checkpoint_path, map_location="cpu",
                      weights_only=False)
    state_dict = ckpt.get("model_state_dict", ckpt)
    has_down4 = any("down4" in k for k in state_dict)
    first = state_dict["inc.double_conv.0.weight"]
    cls = UNet3D if has_down4 else UNet3DLight
    model = cls(n_channels=int(first.shape[1]), n_classes=1,
                base_channels=int(first.shape[0]))
    model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def normalize_volume_to_uint8(volume: np.ndarray) -> np.ndarray:
    """Global min-max normalize a (Z, H, W) volume to uint8 (reference
    `nomalize_volume`, inference.py:139-152); flat volumes map to 128."""
    volume = np.asarray(volume)
    gmin, gmax = float(volume.min()), float(volume.max())
    if gmax > gmin:
        out = (volume - gmin) / (gmax - gmin) * 255.0
        return out.astype(np.uint8)
    return np.full(volume.shape, 128, np.uint8)


def save_results(predicted_diff: np.ndarray, output_dir: str,
                 base_name: str, original_volume: np.ndarray | None = None
                 ) -> dict:
    """Dump a predicted HU difference map like the reference's
    `save_results` (modules/nmodel/inference.py:85-136): the diff volume as
    `{base}_predicted_diff.npy`, per-slice globally-normalized grayscale
    PNGs under `{base}_diff_slices/slice_{i:04d}.png`, and — when the
    original NCCT volume is given — the combined (original + diff) `.npy`
    plus its own slice PNG set. PIL stands in for the reference's cv2.
    Returns the written paths."""
    import os

    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    predicted_diff = np.asarray(predicted_diff, np.float32)
    written = {}

    volume_path = os.path.join(output_dir, f"{base_name}_predicted_diff.npy")
    np.save(volume_path, predicted_diff)
    written["diff_volume"] = volume_path

    def dump_slices(volume, subdir):
        slice_dir = os.path.join(output_dir, subdir)
        os.makedirs(slice_dir, exist_ok=True)
        for i, img in enumerate(normalize_volume_to_uint8(volume)):
            Image.fromarray(img, mode="L").save(
                os.path.join(slice_dir, f"slice_{i:04d}.png"))
        return slice_dir

    written["diff_slices"] = dump_slices(predicted_diff,
                                         f"{base_name}_diff_slices")

    if original_volume is not None:
        combined = np.asarray(original_volume, np.float32) + predicted_diff
        combined_path = os.path.join(output_dir, f"{base_name}_combined.npy")
        np.save(combined_path, combined)
        written["combined_volume"] = combined_path
        written["combined_slices"] = dump_slices(
            combined, f"{base_name}_combined_slices")
    return written
