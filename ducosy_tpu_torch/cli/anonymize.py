"""Anonymization CLI (cli/anonymize.py; reference anonymize.py:17-151).

    python -m ducosy_tpu_torch.cli.anonymize --input_dir_root IN \
        --output_dir_root OUT --dataset_names NAME [--mask]

Strips PHI tags (PatientID -> uuid4[:8], name/sex/age/birthdate/
institution/physician, normalized study/series fields), records a
Category/Site/Original/Anonymized mapping CSV, and exports each patient's
z-sorted HU volume as ``<anon_id>.npy`` under
``<output_dir_root>/anonymized/``; ``--mask`` reads the masked tree. The
JAX CLI's flags; host work only.
"""
import argparse
import csv
import glob
import os
import shutil
import uuid

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DICOM anonymization")
    p.add_argument("--input_dir_root", type=str, default="./data/input")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--cect_folder", type=str, default="POST STD")
    p.add_argument("--mask", action="store_true",
                   help="anonymize the masked outputs instead")
    return p.parse_args(argv)


PHI_OVERRIDES = [
    ("PatientName", "Anonymized"),
    ("PatientSex", "N"),
    ("PatientAge", ""),
    ("PatientBirthDate", ""),
    ("InstitutionName", "Anonymized"),
    ("InstitutionAddress", ""),
    ("ReferringPhysicianName", "Anonymized"),
    ("ImageType", ["PRIMARY", "AXIAL"]),
    ("StudyID", "1"),
    ("StudyDate", "20000101"),
    ("StudyTime", "000000"),
    ("StudyDescription", "-"),
    ("SeriesNumber", "1"),
    ("SeriesDescription", "-"),
]


def anonymize_dataset(ds, anon_id: str):
    """Apply the reference's tag overrides (anonymize.py:97-110) in place."""
    ds.PatientID = anon_id
    for keyword, value in PHI_OVERRIDES:
        try:
            setattr(ds, keyword, value)
        except Exception:
            pass
    return ds


def patient_hu_volume(dcm_paths):
    """z-sorted int16 HU volume of a patient series (anonymize.py:35-39,
    112-127: sorted by ImagePositionPatient z)."""
    from ducosy_tpu_torch.dicom import dcmread

    slices = []
    for path in dcm_paths:
        ds = dcmread(path)
        hu = (ds.pixel_array.astype(np.float32)
              * float(ds.get("RescaleSlope", 1.0))
              + float(ds.get("RescaleIntercept", 0.0))).astype(np.int16)
        ipp = ds.get("ImagePositionPatient", [0.0, 0.0, 0.0])
        z = float(ipp[2]) if isinstance(ipp, list) and len(ipp) >= 3 else 0.0
        slices.append((hu, z))
    slices.sort(key=lambda t: t[1])
    return np.stack([s[0] for s in slices]) if slices else None


def main(argv=None):
    args = parse_args(argv)
    output_dir = os.path.join(args.output_dir_root, "anonymized")
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    mapping_path = os.path.join(args.output_dir_root,
                                "anonymization_mapping.csv")
    with open(mapping_path, "w", newline="") as f:
        csv.writer(f).writerow(
            ["Category", "Site", "OriginalPatientID", "AnonymizedPatientID"])

    if args.mask:
        categories = [("original", os.path.join(args.output_dir_root,
                                                "masked")),
                      ("generated", os.path.join(args.output_dir_root,
                                                 "masked"))]
    else:
        categories = [("original", args.input_dir_root),
                      ("generated", args.output_dir_root)]

    for category, category_dir in categories:
        for dataset_name in args.dataset_names:
            data_dir = os.path.join(category_dir, dataset_name)
            patients = sorted(d for d in glob.glob(os.path.join(data_dir, "*"))
                              if os.path.isdir(d))
            for pdir in patients:
                patient_id = os.path.basename(pdir)
                series_dir = pdir
                if category == "original":
                    series_dir = os.path.join(pdir, args.cect_folder)
                elif args.mask:
                    series_dir = os.path.join(pdir, "generated")
                anon_id = uuid.uuid4().hex[:8]
                dcm_list = sorted(glob.glob(os.path.join(series_dir,
                                                         "*.dcm")))
                if not dcm_list:
                    continue
                with open(mapping_path, "a", newline="") as f:
                    csv.writer(f).writerow(
                        [category, dataset_name, patient_id, anon_id])
                vol = patient_hu_volume(dcm_list)
                if vol is not None:
                    np.save(os.path.join(output_dir, f"{anon_id}.npy"), vol)
                print(f"  {category}/{dataset_name}/{patient_id} -> "
                      f"{anon_id} ({len(dcm_list)} slices)")
    print(f"anonymization complete; mapping at {mapping_path}")


if __name__ == "__main__":
    main()
