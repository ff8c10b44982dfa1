"""Heart-mask cleanup CLI (cli/modify_heart_mask.py; reference
modify_heart_mask.py:212-242).

    python -m ducosy_tpu_torch.cli.modify_heart_mask --output_dir_root OUT \
        --dataset_names NAME

For every TotalSegmentator multi-label NIfTI under
``<output_dir_root>/mask/<dataset>/``, clean label 51 (z-gap cut,
anisotropic distance pruning, small-component removal) and save to
``<output_dir_root>/modified_mask/<dataset>/``, in a spawn pool over
patients. The JAX CLI's flags; host work only.
"""
import argparse
import glob
import multiprocessing
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="heart mask cleanup")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--num_workers", type=int, default=4)
    return p.parse_args(argv)


def _worker(task):
    from ducosy_tpu_torch.masks.heart import modify_heart_mask_file

    src, dst = task
    modify_heart_mask_file(src, dst)
    return os.path.basename(src)


def main(argv=None):
    args = parse_args(argv)
    tasks = []
    for dataset in args.dataset_names:
        mask_dir = os.path.join(args.output_dir_root, "mask", dataset)
        out_dir = os.path.join(args.output_dir_root, "modified_mask",
                               dataset)
        os.makedirs(out_dir, exist_ok=True)
        for src in sorted(glob.glob(os.path.join(mask_dir, "*.nii*"))):
            name = os.path.basename(src)
            tasks.append((src, os.path.join(out_dir, name)))
    print(f"cleaning {len(tasks)} heart masks")
    # spawn start method, as the JAX CLI's: a fresh interpreter a worker,
    # the per-worker model of the reference's Pool usage
    with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
        for name in pool.imap_unordered(_worker, tasks):
            print(f"  done {name}")


if __name__ == "__main__":
    main()
