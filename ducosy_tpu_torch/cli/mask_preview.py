"""Mask-generation smoke tool (cli/mask_preview.py; the reference's
test_mask_generation.py:16-106).

    python -m ducosy_tpu_torch.cli.mask_preview SLICE.dcm --output out.png

Loads one DICOM slice, runs the port's anatomical mask generators, prints
pixel statistics, and saves a color overlay PNG (PIL, imported once the
statistics are printed). The slice path is an argument and the exit
status reflects success. Host work only.
"""
import argparse
import os
import sys

import numpy as np

OVERLAY_COLORS = {
    "lung": (0, 160, 255),
    "mediastinum": (255, 200, 0),
    "bone": (255, 80, 80),
    "lung_vessel": (80, 255, 120),
}


def main(argv=None):
    p = argparse.ArgumentParser(description="anatomical mask smoke test")
    p.add_argument("dicom_path")
    p.add_argument("--mask_types", nargs="+",
                   default=["lung", "mediastinum", "bone", "lung_vessel"])
    p.add_argument("--output", default="mask_preview.png")
    args = p.parse_args(argv)

    from ducosy_tpu_torch.dicom import dcmread
    from ducosy_tpu_torch.masks import generate_anatomical_masks

    ds = dcmread(args.dicom_path)
    hu = (ds.pixel_array.astype(np.float32)
          * float(ds.get("RescaleSlope", 1.0))
          + float(ds.get("RescaleIntercept", 0.0)))
    masks = generate_anatomical_masks(hu, args.mask_types)

    total = hu.size
    for name in args.mask_types:
        m = masks.get(name)
        n = int(m.sum()) if m is not None else 0
        print(f"{name:>12}: {n:8d} px ({100.0 * n / total:5.2f}%)")

    # windowed grayscale + colored overlays
    lo, hi = -160.0, 240.0
    gray = (np.clip(hu, lo, hi) - lo) / (hi - lo)
    rgb = np.stack([gray] * 3, axis=-1)
    for name, color in OVERLAY_COLORS.items():
        m = masks.get(name)
        if m is None:
            continue
        for c in range(3):
            ch = rgb[..., c]
            ch[m == 1] = 0.55 * ch[m == 1] + 0.45 * (color[c] / 255.0)
    from PIL import Image
    Image.fromarray((rgb * 255).astype(np.uint8)).save(args.output)
    print(f"overlay saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
