"""Inference + synthesis CLI on one CUDA card (cli/generate.py:30-311).

    python -m ducosy_tpu_torch.cli.generate --input_dir_root DIR \
        --output_dir_root DIR --dataset_names NAME \
        --soft_tissue_model st.pth --lung_model lung.pth

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; the run
raises if no card is visible). For every patient of every dataset the NCCT
series runs through ``DualGeneratorEngine.run_patient`` and the final
sCECT series is written. Patient N+1's DICOM decode runs in an io thread
while patient N computes on the card, and patient N's download and write
follow N+1's launch. ``--quant trunk|full`` (or ``--trunk_int8``, the same
as ``--quant trunk``) serves the quantized modes. Mask-conditioned
checkpoints (what ``cli.train`` writes for SOFT_TISSUE and LUNG) are served
with their masks generated on the host, the next patient's prefetched while
this one computes; ``--soft_squeeze`` gives them the training-time input
squeeze. ``--write_working``, ``--synthesis_mode additive`` and
``--num_devices`` > 1 are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SERIES_DESCRIPTION = "DuCoSyGAN sCECT v2"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DuCoSy-GAN inference (PyTorch)")
    p.add_argument("--input_dir_root", type=str, default="./data/input")
    p.add_argument("--working_dir_root", type=str, default="./data/working")
    p.add_argument("--output_dir_root", type=str, default="./data/output")
    p.add_argument("--dataset_names", type=str, nargs="+", default=[])
    p.add_argument("--ncct_folder", type=str, default="POST VUE")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--slice_batch", type=int, default=32)
    p.add_argument("--soft_tissue_model", type=str,
                   default="./checkpoints/v3/Soft_Tissue_Generator_A2B.pth")
    p.add_argument("--lung_model", type=str,
                   default="./checkpoints/v3/Lung_Generator_A2B.pth")
    p.add_argument("--window_center", type=float, default=40.0)
    p.add_argument("--window_width", type=float, default=400.0)
    p.add_argument("--write_working", action="store_true",
                   help="also write raw/soft_tissue/lung working DICOMs "
                        "(not ported yet)")
    p.add_argument("--synthesis_mode", type=str, default="overwrite",
                   choices=["overwrite", "additive"],
                   help="additive needs --write_working (not ported yet)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=None,
                   help="multi-card serving (not ported yet)")
    p.add_argument("--trunk_int8", action="store_true",
                   help="quantized serving: the trunk's conv2s int8 (same "
                        "as --quant trunk)")
    p.add_argument("--quant", type=str, default=None,
                   choices=["trunk", "full"],
                   help="quantized serving mode: 'trunk' = each residual "
                        "block's conv2 int8; 'full' = also the stem, down, "
                        "up2 and head convs at static scales on the int8 "
                        "grids (larger deviation; validate on your "
                        "checkpoints)")
    p.add_argument("--soft_squeeze", action="store_true",
                   help="normalize model inputs with the training-time "
                        "soft squeeze instead of the linear serving window: "
                        "for checkpoints trained with use_soft_squeezing "
                        "(the released ones are served linearly)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    unported = {
        "--write_working": args.write_working,
        "--synthesis_mode additive": args.synthesis_mode != "overwrite",
        "--num_devices": (args.num_devices or 1) > 1,
    }
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch CLI yet (ROADMAP.md "
                "Queue 1)")


def _load_generator(path: str):
    """A ``.pth`` state dict, or a ``.npz`` JAX params archive (keys joined
    with '/', as ducosy_tpu.train.checkpoint writes them)."""
    from ducosy_tpu_torch.models.convert import (
        generator_state_dict_from_jax, load_torch_state_dict)

    if not path.endswith(".npz"):
        return load_torch_state_dict(path)
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return generator_state_dict_from_jax(tree)


def load_engine(args):
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    return DualGeneratorEngine(_load_generator(args.soft_tissue_model),
                               _load_generator(args.lung_model),
                               img_size=args.img_size, compute_dtype=dtype,
                               device=args.device, quant=args.quant,
                               trunk_int8=args.trunk_int8,
                               soft_squeeze=args.soft_squeeze)


def _read_series(folder):
    """Sorted, readable slices of a series; an unreadable slice is skipped
    with a warning, as the reference does (generate.py:128-132)."""
    from ducosy_tpu_torch.data.pairing import sort_dicom_files
    from ducosy_tpu_torch.dicom import dcmread

    files = sort_dicom_files(glob.glob(os.path.join(folder, "*.dcm")))
    kept, datasets, shape = [], [], None
    for f in files:
        try:
            ds = dcmread(f)
            px = ds.pixel_array
            if shape is not None and px.shape != shape:
                raise ValueError(f"slice shape {px.shape} != series {shape}")
            shape = px.shape
        except Exception as e:  # per-slice boundary: skip and go on
            print(f"  warning: skipping unreadable slice {f}: {e}")
            continue
        kept.append(f)
        datasets.append(ds)
    return kept, datasets


def _final_tags(out_ds, merged, series_description=SERIES_DESCRIPTION):
    """Final writeback tag surgery (generate.py:272-292). The pixel data is
    written uncompressed, so the transfer syntax is reset to Explicit VR
    LE: a dataset read from a compressed series would otherwise keep its
    encapsulated syntax and be written as raw bytes under it."""
    from ducosy_tpu_torch.dicom.codec import EXPLICIT_VR_LE

    out_ds.transfer_syntax_uid = EXPLICIT_VR_LE
    out_ds.PixelData = np.ascontiguousarray(merged).tobytes()
    vr = "US" if int(out_ds.get("PixelRepresentation", 0)) == 0 else "SS"
    out_ds.add_new((0x0028, 0x0106), vr, int(merged.min()))
    out_ds.add_new((0x0028, 0x0107), vr, int(merged.max()))
    out_ds.WindowWidth = float(250 - (-1000))
    out_ds.WindowCenter = float(-1000 + (250 - (-1000)) / 2)
    out_ds.SeriesDescription = series_description


def _write_final(datasets, final, dtype, out_patient):
    for idx, src in enumerate(datasets):
        out_ds = src.copy()
        _final_tags(out_ds, final[idx].astype(dtype))
        out_ds.save_as(os.path.join(out_patient, f"{idx:04d}.dcm"))


def _load_patient(args, patient_dir):
    ncct_path = os.path.join(patient_dir, args.ncct_folder)
    if not os.path.isdir(ncct_path):
        return None
    files, datasets = _read_series(ncct_path)
    if not files:
        return None
    slope = float(datasets[0].get("RescaleSlope", 1.0))
    intercept = float(datasets[0].get("RescaleIntercept", 0.0))
    volume = np.stack([ds.pixel_array for ds in datasets])
    return datasets, volume, slope, intercept


def _finish(patient_dir, datasets, dtype, out_patient, device_out) -> int:
    """Download one patient's result, write its series, report it."""
    _write_final(datasets, device_out.cpu().numpy(), dtype, out_patient)
    print(f"  done {os.path.basename(patient_dir)}")
    return 1


def run_fast_pipeline(engine, args, patients, output_dir) -> int:
    """Patients in order; the next two patients' DICOM decode (and, for
    mask-conditioned checkpoints, the start of their mask generation) runs
    in io threads while the card works, and patient N's result is
    downloaded and written after patient N+1 has been launched."""
    def load_and_prefetch(p):
        data = _load_patient(args, p)
        if data is None:
            return None
        _, volume, slope, intercept = data
        return (*data, engine.prefetch_masks(volume, slope, intercept))

    done = 0
    with ThreadPoolExecutor(2, thread_name_prefix="io") as io_pool:
        loads = {p: io_pool.submit(load_and_prefetch, p)
                 for p in patients[:2]}
        inflight = []  # _finish arguments of launched, unwritten patients
        for i, pdir in enumerate(patients):
            if i + 2 < len(patients):
                nxt = patients[i + 2]
                loads[nxt] = io_pool.submit(load_and_prefetch, nxt)
            data = loads.pop(pdir).result()
            if data is None:
                continue
            datasets, volume, slope, intercept, mask_fut = data
            out = engine.run_patient_async(volume, slope, intercept,
                                           chunk=args.slice_batch,
                                           masks=mask_fut)
            out_patient = os.path.join(output_dir, os.path.basename(pdir))
            os.makedirs(out_patient, exist_ok=True)
            inflight.append((pdir, datasets, volume.dtype, out_patient, out))
            if len(inflight) > 1:
                done += _finish(*inflight.pop(0))
        for item in inflight:
            done += _finish(*item)
    return done


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    engine = load_engine(args)
    total = 0
    for dataset_name in args.dataset_names:
        input_dir = os.path.join(args.input_dir_root, dataset_name)
        output_dir = os.path.join(args.output_dir_root, dataset_name)
        os.makedirs(output_dir, exist_ok=True)
        patients = sorted(d for d in glob.glob(os.path.join(input_dir, "*"))
                          if os.path.isdir(d))
        print(f"dataset {dataset_name}: {len(patients)} patients")
        total += run_fast_pipeline(engine, args, patients, output_dir)
    print(f"generation+synthesis complete: {total} patients")
    return total


if __name__ == "__main__":
    main()
