"""Evaluation CLI on one CUDA card (cli/calculate.py; reference
calculate.py:848-868).

    python -m ducosy_tpu_torch.cli.calculate --input_dir_root DIR \
        --output_dir_root DIR --dataset_names NAME --fast

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; the run
raises if no card is visible, ``--device cpu`` runs on the CPU). It caches
every series as an HU volume, computes the 12-metric suite over all
patients in a spawn process pool (MS-SSIM and LPIPS on the device), and
writes the per-slice CSVs, the summary statistics and, without ``--fast``,
the figures (matplotlib).
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DuCoSy-GAN evaluation suite "
                                            "(PyTorch)")
    p.add_argument("--input_dir_root", type=str, default="./data/input")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--ncct_folder", type=str, default="POST VUE")
    p.add_argument("--cect_folder", type=str, default="POST STD")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--reset", action="store_true",
                   help="clear the conversion + result caches first")
    p.add_argument("--fast", action="store_true",
                   help="skip figures")
    p.add_argument("--mask", action="store_true",
                   help="evaluate the masked triplets under <output>/masked")
    p.add_argument("--skip_convert", action="store_true",
                   help="skip DICOM->npy conversion (use existing caches)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of MS-SSIM and LPIPS (default cuda; "
                        "cpu runs them on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the suite; returns {"dataset/patient": {metric: [per pair]}}."""
    args = parse_args(argv)
    from ducosy_tpu_torch.device import require_cuda
    from ducosy_tpu_torch.eval import report
    from ducosy_tpu_torch.eval.lpips import default_weights_path

    device = str(require_cuda(args.device))
    if default_weights_path() is None:
        print("note: no LPIPS weights found — the lpips column will be NaN "
              "(like the reference without its lpips package). Provision "
              "them once with scripts/export_lpips_weights.py, or point "
              "DUCOSY_LPIPS_WEIGHTS at an existing lpips_alex.npz/.pth.")

    calc_dir, data_dir, tasks = report.convert(
        args.input_dir_root, args.output_dir_root, args.dataset_names,
        ncct_folder=args.ncct_folder, cect_folder=args.cect_folder,
        reset=args.reset, masked=args.mask, skip_convert=args.skip_convert)
    print(f"converted {len(tasks)} patients -> {data_dir}")
    results = report.calculate(data_dir, calc_dir, tasks,
                               num_workers=args.num_workers,
                               use_cache=not args.reset, device=device)
    print(f"computed metrics for {len(results)} patients")
    summary = report.summary_statistics(results, calc_dir)
    print(f"summary: {summary}")
    if not args.fast:
        figs = report.save_figures(results, calc_dir)
        print(f"figures: {figs}")
    return results


if __name__ == "__main__":
    main()
