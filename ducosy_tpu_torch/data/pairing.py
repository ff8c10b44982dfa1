"""Patient discovery and NCCT/CECT slice pairing.

Reproduces the reference DicomDataset's pairing policy
(modules/dataset.py:72-104): per patient, glob `{ncct,cect}` folders for
*.dcm, sort primarily by InstanceNumber, fall back to SliceLocation, then to
plain filename sort, and zip the two series positionally. The patient-level
80/20 split with seed 42 matches trainer.py:422-427 (random.shuffle on the
sorted dir list).
"""
from __future__ import annotations

import glob
import os
import random
from typing import List, Sequence, Tuple



def list_patient_dirs(data_root: str, dataset_names: str) -> List[str]:
    """Sorted patient directories under data_root/dataset_names
    (trainer.py:422)."""
    return sorted(
        d for d in glob.glob(os.path.join(data_root, dataset_names, "*"))
        if os.path.isdir(d))


def train_val_split(patient_dirs: Sequence[str], val_split: float,
                    seed: int = 42) -> Tuple[List[str], List[str]]:
    """Seeded shuffle then head/tail split — val is the FIRST val_count
    entries of the shuffled list (trainer.py:423-427)."""
    dirs = list(patient_dirs)
    rng = random.Random(seed)
    rng.shuffle(dirs)
    val_count = int(len(dirs) * val_split)
    return dirs[val_count:], dirs[:val_count]


def sort_dicom_files(files: List[str]) -> List[str]:
    """InstanceNumber -> SliceLocation -> filename sort order
    (modules/dataset.py:82-90). Header parsing uses the native C parser when
    built (one pass, no pixel decode)."""
    files = sorted(files)
    if not files:
        return files
    from ducosy_tpu_torch.dicom.native import read_slice_any

    try:
        infos = [(read_slice_any(p, pixels=False), p) for p in files]
    except (ValueError, NotImplementedError, EOFError):
        return files
    if all(i.instance_number for i, _ in infos):
        return [p for _, p in sorted(infos, key=lambda t: t[0].instance_number)]
    if any(i.slice_location for i, _ in infos):
        return [p for _, p in sorted(infos, key=lambda t: t[0].slice_location)]
    return files


def pair_patient_slices(patient_dir: str, ncct_folder: str,
                        cect_folder: str) -> List[Tuple[str, str]]:
    """Positional zip of the sorted NCCT and CECT series of one patient;
    empty when either series is missing (modules/dataset.py:76-104)."""
    ncct = glob.glob(os.path.join(patient_dir, ncct_folder, "*.dcm"))
    cect = glob.glob(os.path.join(patient_dir, cect_folder, "*.dcm"))
    if not ncct or not cect:
        return []
    return list(zip(sort_dicom_files(ncct), sort_dicom_files(cect)))
