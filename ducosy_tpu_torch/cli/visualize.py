"""Visualization CLI (cli/visualize.py; reference visualize.py:16-317).

    python -m ducosy_tpu_torch.cli.visualize --input_dir_root IN \
        --output_dir_root OUT --dataset_names NAME

Per-slice side-by-side VUE / STD / Generated comparison PNGs (threaded
over slices) plus a per-dataset grid of each patient's middle comparison
row, written with PIL under ``<output_dir_root>/visualized/``. The JAX
CLI's flags; host work only.
"""
import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="comparison sheet generator")
    p.add_argument("--input_dir_root", type=str, default="./data/input")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--ncct_folder", type=str, default="POST VUE")
    p.add_argument("--cect_folder", type=str, default="POST STD")
    p.add_argument("--window_center", type=float, default=40.0)
    p.add_argument("--window_width", type=float, default=400.0)
    p.add_argument("--num_workers", type=int, default=8)
    return p.parse_args(argv)


def _window(hu, wc, ww):
    lo, hi = wc - ww / 2.0, wc + ww / 2.0
    return ((np.clip(hu, lo, hi) - lo) / ww * 255).astype(np.uint8)


def _hu_slices(dcm_dir):
    from ducosy_tpu_torch.data.pairing import sort_dicom_files
    from ducosy_tpu_torch.dicom import dcmread

    out = []
    for path in sort_dicom_files(glob.glob(os.path.join(dcm_dir, "*.dcm"))):
        ds = dcmread(path)
        out.append(ds.pixel_array.astype(np.float32)
                   * float(ds.get("RescaleSlope", 1.0))
                   + float(ds.get("RescaleIntercept", 0.0)))
    return out


def save_comparison_image(task):
    """One [VUE | STD | Generated] windowed row -> PNG."""
    from PIL import Image, ImageDraw

    vue, std, gen, wc, ww, out_path = task
    panels = [_window(x, wc, ww) for x in (vue, std, gen)]
    row = np.concatenate(panels, axis=1)
    img = Image.fromarray(row).convert("RGB")
    draw = ImageDraw.Draw(img)
    w = vue.shape[1]
    for i, label in enumerate(("VUE (NCCT)", "STD (CECT)", "Generated")):
        draw.text((i * w + 6, 6), label, fill=(255, 220, 0))
    img.save(out_path)
    return out_path


def main(argv=None):
    args = parse_args(argv)
    grid_rows = {}
    for dataset_name in args.dataset_names:
        in_base = os.path.join(args.input_dir_root, dataset_name)
        gen_base = os.path.join(args.output_dir_root, dataset_name)
        vis_base = os.path.join(args.output_dir_root, "visualized",
                                dataset_name)
        patients = sorted(d for d in glob.glob(os.path.join(in_base, "*"))
                          if os.path.isdir(d))
        tasks = []
        for pdir in patients:
            pid = os.path.basename(pdir)
            gen_dir = os.path.join(gen_base, pid)
            if not os.path.isdir(gen_dir):
                continue
            vue = _hu_slices(os.path.join(pdir, args.ncct_folder))
            std = _hu_slices(os.path.join(pdir, args.cect_folder))
            gen = _hu_slices(gen_dir)
            n = min(len(vue), len(std), len(gen))
            if n == 0:
                continue
            out_dir = os.path.join(vis_base, pid)
            os.makedirs(out_dir, exist_ok=True)
            for i in range(n):
                tasks.append((vue[i], std[i], gen[i], args.window_center,
                              args.window_width,
                              os.path.join(out_dir, f"{i:04d}.png")))
            mid = n // 2
            grid_rows.setdefault(dataset_name, []).append(
                np.concatenate([_window(x, args.window_center,
                                        args.window_width)
                                for x in (vue[mid], std[mid], gen[mid])],
                               axis=1))
        with ThreadPoolExecutor(args.num_workers) as pool:
            done = list(pool.map(save_comparison_image, tasks))
        print(f"{dataset_name}: wrote {len(done)} comparison images")

        rows = grid_rows.get(dataset_name, [])
        if rows:
            from PIL import Image
            h = min(r.shape[0] for r in rows)
            w = min(r.shape[1] for r in rows)
            grid = np.concatenate([r[:h, :w] for r in rows], axis=0)
            grid_path = os.path.join(args.output_dir_root, "visualized",
                                     f"{dataset_name}_grid.png")
            Image.fromarray(grid).save(grid_path)
            print(f"{dataset_name}: grid -> {grid_path}")


if __name__ == "__main__":
    main()
