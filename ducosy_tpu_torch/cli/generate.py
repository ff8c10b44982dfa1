"""Inference + synthesis CLI (cli/generate.py:30-311).

    python -m ducosy_tpu_torch.cli.generate --input_dir_root DIR \
        --output_dir_root DIR --dataset_names NAME \
        --soft_tissue_model st.pth --lung_model lung.pth

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; the run
raises if no card is visible). The engine resolves its forward as the
JAX engine does: the packed forward with the chain3 trunk on a card, the
module forward on the CPU (``infer/engine.py``). Two modes, as the JAX
CLI's:
  - the fast path (default): every patient's NCCT series runs through
    ``DualGeneratorEngine.run_patient`` and the final sCECT v2 series is
    written. Patient N+1's DICOM decode runs in an io thread while patient
    N computes on the card, and patient N's download and write follow
    N+1's launch;
  - ``--write_working``: ``generate_batch`` in chunks of ``--slice_batch``
    slices, the working series raw/ (the source files copied),
    soft_tissue/ and lung/ written under ``--working_dir_root``, then the
    synthesis on the card: ``--synthesis_mode overwrite`` composites the
    two outputs into the NCCT (sCECT v2), ``additive`` adds their HU
    enhancements to it (sCECT v3). ``--synthesis_mode additive`` without
    ``--write_working`` serves the fast path, as in the JAX CLI.
``--quant trunk|full`` (or ``--trunk_int8``, the same as ``--quant trunk``)
serves the quantized modes. Mask-conditioned checkpoints (what
``cli.train`` writes for SOFT_TISSUE and LUNG) are served with their masks
generated on the host (on the fast path the next patient's prefetched
while this one computes); ``--soft_squeeze`` gives them the training-time
input squeeze. ``--num_devices N`` > 1 serves each chunk in N parts on
the first N cards (N CPU replicas with ``--device cpu``), as the JAX CLI's
``data_mesh(N)``; more cards than are visible raises, and
``--slice_batch`` must divide by N.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SERIES_DESCRIPTION = "DuCoSyGAN sCECT v2"
ADDITIVE_DESCRIPTION = "DuCoSyGAN sCECT v3"


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
                   help="also write raw/soft_tissue/lung working DICOMs")
    p.add_argument("--synthesis_mode", type=str, default="overwrite",
                   choices=["overwrite", "additive"],
                   help="overwrite = sCECT v2 compositing; additive = the "
                        "v3 enhancement-delta path (with --write_working)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=None,
                   help="serve each chunk in parts on this many cards")
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
    from ducosy_tpu_torch.parallel.mesh import data_mesh

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    mesh = None
    if args.num_devices and args.num_devices > 1:
        mesh = data_mesh(args.num_devices) \
            if torch.device(args.device).type == "cuda" \
            else data_mesh(devices=[args.device] * args.num_devices)
    return DualGeneratorEngine(_load_generator(args.soft_tissue_model),
                               _load_generator(args.lung_model),
                               img_size=args.img_size, compute_dtype=dtype,
                               device=args.device, mesh=mesh,
                               quant=args.quant, trunk_int8=args.trunk_int8,
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


def _pixel_swap(out_ds, px, vr: str) -> None:
    """Put ``px`` in as the pixel data, uncompressed, with the smallest and
    largest pixel value tags (0x0028,0x0106/0107) in ``vr``. The transfer
    syntax is reset to Explicit VR LE: a dataset read from a compressed
    series would otherwise keep its encapsulated syntax and be written as
    raw bytes under it."""
    from ducosy_tpu_torch.dicom.codec import EXPLICIT_VR_LE

    out_ds.transfer_syntax_uid = EXPLICIT_VR_LE
    out_ds.PixelData = np.ascontiguousarray(px).tobytes()
    out_ds.add_new((0x0028, 0x0106), vr, int(px.min()))
    out_ds.add_new((0x0028, 0x0107), vr, int(px.max()))


def _final_tags(out_ds, merged, series_description=SERIES_DESCRIPTION):
    """Final writeback tag surgery (generate.py:272-292)."""
    vr = "US" if int(out_ds.get("PixelRepresentation", 0)) == 0 else "SS"
    _pixel_swap(out_ds, merged, vr)
    out_ds.WindowWidth = float(250 - (-1000))
    out_ds.WindowCenter = float(-1000 + (250 - (-1000)) / 2)
    out_ds.SeriesDescription = series_description


def _write_final(datasets, final, dtype, out_patient,
                 series_description=SERIES_DESCRIPTION):
    for idx, src in enumerate(datasets):
        out_ds = src.copy()
        _final_tags(out_ds, final[idx].astype(dtype), series_description)
        out_ds.save_as(os.path.join(out_patient, f"{idx:04d}.dcm"))


def _write_working(files, datasets, out, dtype, wdir) -> None:
    """The working series (generate.py:21-134): raw/ the source files
    copied; soft_tissue/ and lung/ each source dataset with the model's
    stored output cast to the series dtype."""
    for sub in ("raw", "soft_tissue", "lung"):
        os.makedirs(os.path.join(wdir, sub), exist_ok=True)
    for i, (path, src) in enumerate(zip(files, datasets)):
        name = os.path.basename(path)
        shutil.copy(path, os.path.join(wdir, "raw", name))
        for sub, arr in (("soft_tissue", out["st_stored"][i]),
                         ("lung", out["lung_stored"][i])):
            ds = src.copy()
            ds.SeriesDescription = (
                f"Synthetic CECT (from {src.get('SeriesDescription', '')})")
            px = arr.astype(dtype)
            _pixel_swap(ds, px, "US" if px.dtype.kind == "u" else "SS")
            ds.save_as(os.path.join(wdir, sub, name))


def synthesize(engine, out, volume, slope, intercept, mode: str):
    """The final int16 volume from ``generate_batch`` outputs, on the
    engine's device: (volume, series description)."""
    from ducosy_tpu_torch.infer import synthesis

    dev = engine.device
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    raw = up(volume.astype(np.float32))
    raw_hu, st, lung = up(out["raw_hu"]), up(out["st_stored"]), \
        up(out["lung_stored"])
    with torch.inference_mode():
        if mode == "additive":
            merged = synthesis.additive_composite(
                raw, raw_hu, st * slope + intercept, lung * slope + intercept,
                slope)
            desc = ADDITIVE_DESCRIPTION
        else:
            merged = synthesis.composite_volume(
                raw, raw_hu, st, lung, engine.st_range, engine.lung_range)
            desc = SERIES_DESCRIPTION
        return synthesis.synthesize_volume(merged).cpu().numpy(), desc


def process_patient(engine, args, patient_dir, working_dir, output_dir):
    """One patient on the working path (cli/generate.py:142-209): both
    models over the series in chunks, the working series, the synthesis and
    the final series. False if the patient has no readable NCCT series."""
    loaded = _load_patient(args, patient_dir)
    if loaded is None:
        return False
    files, datasets, volume, slope, intercept = loaded
    patient_id = os.path.basename(patient_dir)
    out = engine.generate_batch(volume, slope, intercept,
                                chunk=args.slice_batch)
    _write_working(files, datasets, out, volume.dtype,
                   os.path.join(working_dir, patient_id))
    final, desc = synthesize(engine, out, volume, slope, intercept,
                             args.synthesis_mode)
    out_patient = os.path.join(output_dir, patient_id)
    os.makedirs(out_patient, exist_ok=True)
    _write_final(datasets, final, volume.dtype, out_patient, desc)
    return True


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
    return files, datasets, volume, slope, intercept


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
        _, _, volume, slope, intercept = data
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
            _, datasets, volume, slope, intercept, mask_fut = data
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
    if args.synthesis_mode == "additive" and not args.write_working:
        print("note: --synthesis_mode additive takes effect with "
              "--write_working only (as in the JAX CLI); serving the fast "
              "path (sCECT v2)")
    engine = load_engine(args)
    print(f"generator forward: {engine.forward_impl}, trunk {engine.trunk}")
    total = 0
    for dataset_name in args.dataset_names:
        input_dir = os.path.join(args.input_dir_root, dataset_name)
        working_dir = os.path.join(args.working_dir_root, dataset_name)
        output_dir = os.path.join(args.output_dir_root, dataset_name)
        os.makedirs(output_dir, exist_ok=True)
        patients = sorted(d for d in glob.glob(os.path.join(input_dir, "*"))
                          if os.path.isdir(d))
        print(f"dataset {dataset_name}: {len(patients)} patients")
        if not args.write_working:
            total += run_fast_pipeline(engine, args, patients, output_dir)
            continue
        for pdir in patients:
            if process_patient(engine, args, pdir, working_dir, output_dir):
                total += 1
                print(f"  done {os.path.basename(pdir)}")
    print(f"generation+synthesis complete: {total} patients")
    return total


if __name__ == "__main__":
    main()
