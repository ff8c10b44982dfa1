"""Weights and inputs made from ``--seed`` on the device, in a few large
calls: the same seed gives the same tensors on both sides of a comparison,
and the reference makes its own copy rather than read the program's.

Weights: every weight N(0, init_std), every bias zero (the reference's
``weights_init_normal``), fp32, in the reference's state-dict layout.

Inputs: a chest CT phantom (the port's smoke script's ``chest_phantom``,
vectorised over slices): air, an elliptic body, two lungs with six vessels
each that wander along z, an aorta (enhanced under contrast), a spine, and
seeded noise; stored int16 values HU + 1024. A patient's series is one
volume whose structure drifts along z, the same for every seed; a training
batch holds slices each with its own anatomy drawn from the seed. Only
pixels change with the seed, never the shapes of the work.
"""
from __future__ import annotations

import math

import torch

HU_OFFSET = 1024.0


def derive(seed: int, *tags: int) -> int:
    """A seed for one stream (a network, a volume) of a run's seed."""
    h = seed % (1 << 62)
    for t in tags:
        h = (h * 1_000_003 + 7919 * (t + 1)) % (1 << 62)
    return h


def generator_shapes(in_ch: int, base: int, blocks: int, cbam: bool = True,
                     reduction: int = 16, sa_kernel: int = 7) -> dict:
    """State-dict key -> shape of the ResNet-9 + CBAM generator
    (modules/model.py:94-113)."""
    c = 4 * base
    shapes = {}

    def conv(key, o, i, k):
        shapes[f"{key}.weight"] = (o, i, k, k)
        shapes[f"{key}.bias"] = (o,)

    conv("model.1", base, in_ch, 7)
    conv("model.4", 2 * base, base, 3)
    conv("model.7", c, 2 * base, 3)
    for i in range(blocks):
        b = f"model.{10 + i}"
        conv(f"{b}.block.1", c, c, 3)
        conv(f"{b}.block.5", c, c, 3)
        if cbam:
            ca = f"{b}.cbam.channel_attention.fc"
            shapes[f"{ca}.0.weight"] = (c // reduction, c, 1, 1)
            shapes[f"{ca}.2.weight"] = (c, c // reduction, 1, 1)
            shapes[f"{b}.cbam.spatial_attention.conv.weight"] = \
                (1, 2, sa_kernel, sa_kernel)
    conv(f"model.{11 + blocks}", 2 * base, c, 3)
    conv(f"model.{15 + blocks}", base, 2 * base, 3)
    conv(f"model.{19 + blocks}", 1, base, 7)
    return shapes


def discriminator_shapes(in_ch: int, base: int) -> dict:
    """State-dict key -> shape of the PatchGAN (modules/model.py:118-131)."""
    chans = (in_ch, base, 2 * base, 4 * base, 8 * base, 1)
    shapes = {}
    for i, idx in enumerate((0, 2, 5, 8, 12)):
        shapes[f"model.{idx}.weight"] = (chans[i + 1], chans[i], 4, 4)
        shapes[f"model.{idx}.bias"] = (chans[i + 1],)
    return shapes


def init_weights(shapes: dict, seed: int, std: float, device) -> dict:
    """One N(0, std) draw for all the weights of a network, split into its
    keys in order; zero biases."""
    n = sum(math.prod(s) for k, s in shapes.items() if k.endswith("weight"))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device) * std
    out, at = {}, 0
    for key, shape in shapes.items():
        if key.endswith("bias"):
            out[key] = torch.zeros(shape, device=device)
        else:
            size = math.prod(shape)
            out[key] = flat[at:at + size].view(shape)
            at += size
    return out


def generator_weights(gen_cfg: dict, in_ch: int, seed: int, device) -> dict:
    return init_weights(generator_shapes(
        in_ch, gen_cfg["base_channels"], gen_cfg["num_residual_blocks"],
        gen_cfg["cbam"], gen_cfg["cbam_reduction"],
        gen_cfg["cbam_spatial_kernel"]), seed, gen_cfg["init_std"], device)


def discriminator_weights(disc_cfg: dict, seed: int, device) -> dict:
    return init_weights(discriminator_shapes(1, disc_cfg["base_channels"]),
                        seed, disc_cfg["init_std"], device)


def _grid(size: int, device):
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    return ax[:, None], ax[None, :]


# ranges of the per-slice draws of ``slice_geometry(seed=...)``: small and
# large patients, apex to base of the lungs, contrast phases and doses
RANGES = {"body_y": (0.30, 0.46), "body_x": (0.34, 0.48),
          "body_hu": (10.0, 70.0), "lung_h": (0.10, 0.30),
          "lung_w": (0.10, 0.17), "lung_cy": (0.42, 0.54),
          "lung_dx": (0.15, 0.21), "aorta_r2": (0.0015, 0.0045),
          "vessel_hu": (100.0, 300.0), "aorta_hu": (150.0, 450.0),
          "spine_hu": (400.0, 900.0), "noise": (6.0, 25.0), "f": (0.0, 1.0)}


def slice_geometry(z: int, device, seed: int | None = None) -> dict:
    """Per-slice parameters of the phantom, each (z, 1, 1) or a number.
    Without a seed, one volume whose structure drifts along z (the smoke
    script's phantom: a patient's series); with a seed, every slice its own
    body, lungs, contrast and noise drawn from it (slices of many patients,
    as a shuffled training batch holds them)."""
    if seed is None:
        f = (torch.arange(z, device=device, dtype=torch.float32)
             / max(z - 1, 1))[:, None, None]
        return {"f": f, "body_y": 0.42, "body_x": 0.46, "body_hu": 40.0,
                "lung_h": 0.25 + 0.03 * f, "lung_w": 0.15, "lung_cy": 0.48,
                "lung_dx": 0.19, "aorta_r2": 0.003, "vessel_hu": 180.0,
                "aorta_hu": 300.0, "spine_hu": 650.0, "noise": 12.0}
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((len(RANGES), z, 1, 1), generator=gen, device=device)
    return {k: lo + (hi - lo) * u[i]
            for i, (k, (lo, hi)) in enumerate(RANGES.items())}


def body_mask(size: int, device, g: dict) -> torch.Tensor:
    yy, xx = _grid(size, device)
    return ((yy - 0.5) / g["body_y"]) ** 2 + \
        ((xx - 0.5) / g["body_x"]) ** 2 < 1


def lung_masks(size: int, device, g: dict):
    yy, xx = _grid(size, device)
    for side in (-1, 1):
        cx = 0.5 + side * g["lung_dx"]
        yield cx, ((yy - g["lung_cy"]) / g["lung_h"]) ** 2 + \
            ((xx - cx) / g["lung_w"]) ** 2 < 1


def spine_mask(size: int, device) -> torch.Tensor:
    yy, xx = _grid(size, device)
    return ((xx - 0.5).abs() < 0.05) & (yy > 0.76)


def phantom_hu(z: int, size: int, seed: int, device, contrast=False,
               geometry: dict | None = None) -> torch.Tensor:
    """(z, size, size) fp32 HU of a chest phantom (the port's smoke script's
    ``chest_phantom``, vectorised over slices): air, an elliptic body, two
    lungs with six vessels each, an aorta (enhanced with ``contrast``), a
    spine, and seeded noise; the geometry of ``slice_geometry``."""
    g = geometry or slice_geometry(z, device)
    yy, xx = _grid(size, device)
    body = body_mask(size, device, g)
    hu = torch.where(body, g["body_hu"] + torch.zeros(z, 1, 1, device=device),
                     torch.tensor(-1024.0, device=device))
    for cx, lung in lung_masks(size, device, g):
        hu = torch.where(lung, -850.0, hu)
        for k in range(6):
            vy, vx = 0.35 + 0.05 * k, cx + 0.04 * torch.sin(k + 3 * g["f"])
            vessel = (yy - vy) ** 2 + (xx - vx) ** 2 < 0.0001
            hu = torch.where(vessel, g["vessel_hu"] if contrast else 30.0,
                             hu)
    aorta = (yy - 0.45) ** 2 + (xx - 0.5) ** 2 < g["aorta_r2"]
    hu = torch.where(aorta, g["aorta_hu"] if contrast else 45.0, hu)
    hu = torch.where(spine_mask(size, device) & body, g["spine_hu"], hu)
    gen = torch.Generator(device=device).manual_seed(seed)
    return hu + g["noise"] * torch.randn(hu.shape, generator=gen,
                                         device=device)


def phantom_masks(z: int, size: int, device, geometry: dict) -> dict:
    """The phantom's anatomy as (z, size, size) bool masks: the bone (the
    spine inside the body) and the mediastinum (the body between the lungs,
    above the spine)."""
    yy, xx = _grid(size, device)
    body = body_mask(size, device, geometry)
    lungs = torch.zeros((z, size, size), dtype=torch.bool, device=device)
    for _, lung in lung_masks(size, device, geometry):
        lungs = lungs | lung
    middle = ((yy - 0.5) / 0.28) ** 2 + ((xx - 0.5) / 0.12) ** 2 < 1
    spine = spine_mask(size, device)
    return {"bone": (spine & body).expand(z, size, size),
            "mediastinum": middle & body & ~lungs & ~spine}


def stored_int16(hu: torch.Tensor) -> torch.Tensor:
    return torch.clamp(hu + HU_OFFSET, 0, 4095).to(torch.int16)


def soft_squeeze(hu: torch.Tensor, hu_min: float, hu_max: float,
                 sigma: float = 50.0) -> torch.Tensor:
    """The training dataset's window: HU clipped to [hu_min, hu_max], linear
    below 0.9 of the window and sigmoid-compressed above, to [-1, 1]."""
    n = (torch.clamp(hu, hu_min, hu_max) - hu_min) / (hu_max - hu_min)
    soft = torch.sigmoid((10.0 / sigma) * (n - 0.9))
    return 2.0 * torch.where(n < 0.9, n, 0.9 + 0.1 * soft) - 1.0
