"""TotalSegmentator masking CLI (cli/masking.py; reference masking.py:567-605).

    python -m ducosy_tpu_torch.cli.masking --input_dir_root IN \
        --output_dir_root OUT --dataset_names NAME --stage all

The JAX CLI's flags and stages. ``generate`` converts each patient's CECT
series to NIfTI and runs TotalSegmentator (an external binary on the PATH,
given ``--device``, default gpu) in spawn worker processes, writing
``<output>/mask/<dataset>/<patient>.nii``; ``masking`` builds the 34-label
cardiac/vascular exclusion mask from the heart-cleaned
``<output>/modified_mask/`` NIfTI (``modify_heart_mask`` writes it) and
sets those pixels to 9999 in the NCCT/CECT/sCECT triplets under
``<output>/masked/<dataset>/<patient>/{<ncct>, <cect>, generated}``, the
tree ``calculate --mask`` scores. When the binary is absent the generate
stage reports it for each patient and exits cleanly.

``--segmenter native --nnunet_dir DIR`` runs the generate stage in this
process instead: the nnU-Net model in DIR (the ``<trainer>__<plans>__
3d_fullres`` folder with ``plans.json``, ``dataset.json`` and
``fold_*/checkpoint_final.pth``; ``models/nnunet.py``) on one card
(``--device`` gpu or cuda; cpu runs the plain path in float32), four
patches a forward through ``infer/segment.py``, patient i launched before
patient i - 1 is written. It writes the same ``<patient>.nii``
multilabel volume that the masking stage reads, in the network's own label
values. Those must be TotalSegmentator's merged ``--ml`` IDs: the masking
stage's 34 IDs come from two of the total task's five part networks, so
one part network does not hold them, and the backend then fails every
patient with that reason (``masks/totalseg.label_map_problem``).
``--segmenter totalsegmentator`` (the subprocess) stays the default: no
weights ship with the repository.
"""
import argparse
import glob
import multiprocessing
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="heart/vessel masking pipeline")
    p.add_argument("--input_dir_root", type=str, default="./data/input")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--ncct_folder", type=str, default="POST VUE")
    p.add_argument("--cect_folder", type=str, default="POST STD")
    p.add_argument("--batch_size", type=int, default=4,
                   help="parallel TotalSegmentator workers")
    p.add_argument("--device", type=str, default="gpu")
    p.add_argument("--stage", type=str, default="masking",
                   choices=["generate", "masking", "all"])
    p.add_argument("--segmenter", type=str, default="totalsegmentator",
                   choices=["totalsegmentator", "native"],
                   help="the TotalSegmentator subprocess, or the nnU-Net "
                        "network of --nnunet_dir in process")
    p.add_argument("--nnunet_dir", type=str, default=None,
                   help="trained nnU-Net model folder (--segmenter native) "
                        "whose labels are TotalSegmentator's merged --ml "
                        "IDs; one part network of the total task does not "
                        "hold the masking stage's 34 IDs and is refused")
    args = p.parse_args(argv)
    if args.segmenter == "native" and not args.nnunet_dir:
        p.error("--segmenter native needs --nnunet_dir")
    return args


def native_segmenter(args):
    """The ``Segmenter`` of ``--nnunet_dir`` on ``--device``'s card (bf16)
    or the CPU (float32)."""
    import torch

    from ducosy_tpu_torch.infer.segment import Segmenter
    from ducosy_tpu_torch.models.nnunet import load_nnunet

    device = "cpu" if args.device == "cpu" else "cuda"
    net, plan = load_nnunet(args.nnunet_dir)
    return Segmenter(net, plan, device=device,
                     dtype=torch.float32 if device == "cpu"
                     else torch.bfloat16)


def generate(args):
    """Per patient: DICOM->NIfTI + TotalSegmentator (masking.py:301-380)."""
    from ducosy_tpu_torch.masks.totalseg import (register_signal_handlers,
                                                 segment_patient,
                                                 segment_patients)

    # SIGINT/SIGTERM + atexit teardown of the external segmentation fleet
    # (masking.py:71-95): the parent exits cleanly (terminating the pool),
    # and each worker — via the initializer below — kills its own
    # TotalSegmentator subprocess tree, so an interrupt leaves no orphans.
    register_signal_handlers()

    tasks = []
    for dataset in args.dataset_names:
        base = os.path.join(args.input_dir_root, dataset)
        work = os.path.join(args.output_dir_root, "working", dataset)
        mask = os.path.join(args.output_dir_root, "mask", dataset)
        os.makedirs(mask, exist_ok=True)
        for pdir in sorted(d for d in glob.glob(os.path.join(base, "*"))
                           if os.path.isdir(d)):
            pid = os.path.basename(pdir)
            tasks.append((os.path.join(pdir, args.cect_folder),
                          os.path.join(work, pid),
                          os.path.join(mask, pid), args.device))
    if args.segmenter == "native":
        print(f"segmenting {len(tasks)} patients (in process, "
              f"{args.nnunet_dir})")
        for pid, ok, err in segment_patients(tasks, native_segmenter(args)):
            print(f"  {pid}: {'OK' if ok else f'FAILED — {err}'}")
        return
    print(f"segmenting {len(tasks)} patients "
          f"({args.batch_size} parallel workers)")
    # spawn, not fork: workers start clean, as the JAX CLI's
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.batch_size,
                  initializer=register_signal_handlers) as pool:
        for pid, ok, err in pool.imap_unordered(segment_patient, tasks):
            print(f"  {pid}: {'OK' if ok else f'FAILED — {err}'}")


def masking(args):
    """Apply the exclusion masks to NCCT/CECT/sCECT (masking.py:383-564)."""
    from ducosy_tpu_torch.data.pairing import sort_dicom_files
    from ducosy_tpu_torch.dicom.nifti import read_nifti
    from ducosy_tpu_torch.masks.totalseg import (apply_exclusion_mask,
                                           build_exclusion_mask)

    for dataset in args.dataset_names:
        original = os.path.join(args.input_dir_root, dataset)
        generated = os.path.join(args.output_dir_root, dataset)
        mask_dir = os.path.join(args.output_dir_root, "modified_mask",
                                dataset)
        masked_dir = os.path.join(args.output_dir_root, "masked", dataset)
        os.makedirs(masked_dir, exist_ok=True)

        patients = sorted(d for d in glob.glob(os.path.join(original, "*"))
                          if os.path.isdir(d))
        for pdir in patients:
            pid = os.path.basename(pdir)
            mask_path = os.path.join(mask_dir, f"{pid}.nii")
            if not os.path.exists(mask_path):
                mask_path += ".gz"
            if not os.path.exists(mask_path):
                print(f"  {pid}: no mask file, skipping")
                continue
            data, _aff = read_nifti(mask_path)
            label_volume = np.transpose(np.asarray(data), (2, 1, 0))
            excl = build_exclusion_mask(label_volume.astype(np.int32))

            series = {
                args.ncct_folder: sort_dicom_files(glob.glob(
                    os.path.join(pdir, args.ncct_folder, "*.dcm"))),
                args.cect_folder: sort_dicom_files(glob.glob(
                    os.path.join(pdir, args.cect_folder, "*.dcm"))),
                "generated": sort_dicom_files(glob.glob(
                    os.path.join(generated, pid, "*.dcm"))),
            }
            n = excl.shape[0]
            if any(len(files) != n for files in series.values()):
                print(f"  {pid}: slice count mismatch, skipping")
                continue
            for sub, files in series.items():
                apply_exclusion_mask(
                    files, excl, os.path.join(masked_dir, pid, sub))
            print(f"  {pid}: masked {n} slices x 3 series")


def main(argv=None):
    args = parse_args(argv)
    if args.stage in ("generate", "all"):
        generate(args)
    if args.stage in ("masking", "all"):
        masking(args)


if __name__ == "__main__":
    main()
