"""TotalSegmentator runner + mask application: the port's copy of
ducosy_tpu/masks/totalseg.py (numpy and scipy; no cv2).

Rebuild of the reference masking.py pipeline. TotalSegmentator itself stays
an EXTERNAL subprocess exactly as in the reference (masking.py:239-253) —
its nnU-Net internals are out of scope; this module provides:

  dicom_to_nifti       — z-sorted HU volume -> NIfTI with the hand-rolled
                         affine (masking.py:104-202), via our codecs
  run_totalsegmentator — subprocess with 1200 s timeout and process-tree
                         kill (masking.py:36-68, 255-283); gated: a missing
                         binary returns a clear (ok=False, reason) instead
                         of crashing
  segment_patient      — convert + segment one patient (worker body)
  build_exclusion_mask — select the 34 cardiac/vascular/rib label IDs,
                         fill + 2px dilate each label's rim, then a final
                         4px rim dilation (masking.py:390,455-512), by
                         binary morphology over all slices at once
  apply_exclusion_mask — set masked pixels of NCCT/CECT/sCECT triplets to
                         9999, write uncompressed MONOCHROME2 int16
                         (masking.py:518-560); a compressed source is
                         written as Explicit VR Little Endian (the JAX
                         function keeps its encapsulated syntax, so its
                         save fails there)
"""
from __future__ import annotations

import atexit
import glob
import os
import signal
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage

# 34 cardiac/vascular/rib TotalSegmentator class IDs (masking.py:390)
MASK_TARGET_LABELS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 18, 19, 20, 21, 22, 23,
                      24, 51, 52, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
                      65, 66, 67, 68]
MASK_FILL_VALUE = 9999
TIMEOUT_S = 1200


def kill_process_tree(pid: int):
    """Terminate a process and all children (masking.py:36-68)."""
    try:
        import psutil
        parent = psutil.Process(pid)
        for child in parent.children(recursive=True):
            try:
                child.kill()
            except psutil.NoSuchProcess:
                pass
        parent.kill()
    except Exception:
        # psutil missing or the process already exited: best-effort direct
        # kill so orphans don't outlive an interrupted run
        try:
            os.kill(pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass


# ---------------------------------------------------------- fleet lifecycle
# Per-process registry of live external segmentation subprocesses so an
# interrupted run (SIGINT/SIGTERM or normal exit) never leaks workers —
# the reference installs the same handlers around its fleet
# (masking.py:71-95). Workers register their own subprocess; the Pool
# parent installs the handlers in each worker via `initializer=`.
_ACTIVE_PIDS: set[int] = set()
_PIDS_LOCK = threading.Lock()
_HANDLERS_INSTALLED = False


def _register_pid(pid: int):
    with _PIDS_LOCK:
        _ACTIVE_PIDS.add(pid)


def _unregister_pid(pid: int):
    with _PIDS_LOCK:
        _ACTIVE_PIDS.discard(pid)


def cleanup_workers():
    """Kill every registered external subprocess tree (idempotent)."""
    with _PIDS_LOCK:
        pids = list(_ACTIVE_PIDS)
        _ACTIVE_PIDS.clear()
    for pid in pids:
        kill_process_tree(pid)


def register_signal_handlers():
    """Install SIGINT/SIGTERM handlers + atexit cleanup that tear down any
    live segmentation subprocesses before exiting (masking.py:71-95). Safe
    to call repeatedly; also used as a multiprocessing.Pool initializer so
    each worker cleans up its own subprocess when the pool is terminated."""
    global _HANDLERS_INSTALLED
    if _HANDLERS_INSTALLED:
        return

    def _handler(signum, _frame):
        cleanup_workers()
        sys.exit(128 + signum)

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _handler)
        except ValueError:  # non-main thread: atexit still covers us
            pass
    atexit.register(cleanup_workers)
    _HANDLERS_INSTALLED = True


def dicom_to_nifti(patient_dir: str, nifti_path: str) -> bool:
    """z-sorted DICOM series -> HU NIfTI with DICOM-derived affine."""
    from ducosy_tpu_torch.dicom import dcmread
    from ducosy_tpu_torch.dicom.nifti import dicom_affine, write_nifti

    files = glob.glob(os.path.join(patient_dir, "*.dcm"))
    if not files:
        return False
    slices = []
    for path in files:
        ds = dcmread(path)
        hu = (ds.pixel_array.astype(np.float32)
              * float(ds.get("RescaleSlope", 1.0))
              + float(ds.get("RescaleIntercept", 0.0)))
        ipp = ds.get("ImagePositionPatient", [0.0, 0.0, 0.0])
        z = float(ipp[2]) if isinstance(ipp, list) and len(ipp) >= 3 else \
            float(ds.get("InstanceNumber", 0))
        slices.append((hu, z, ds))
    slices.sort(key=lambda t: t[1])
    vol = np.stack([s[0] for s in slices]).astype(np.int16)
    first = slices[0][2]
    spacing = first.get("PixelSpacing", [1.0, 1.0])
    thickness = float(first.get("SliceThickness", 1.0))
    ipp0 = first.get("ImagePositionPatient", [0.0, 0.0, 0.0])
    affine = dicom_affine(spacing, thickness, ipp0)
    # NIfTI stores (x, y, z); our volume is (z, y, x)
    write_nifti(nifti_path, np.transpose(vol, (2, 1, 0)), affine)
    return True


def run_totalsegmentator(nifti_path: str, out_path: str, *,
                         device: str = "gpu",
                         timeout: int = TIMEOUT_S) -> Tuple[bool, Optional[str]]:
    """Spawn `TotalSegmentator -i ... -o ... --ml` (masking.py:239-283)."""
    cmd = ["TotalSegmentator", "-i", nifti_path, "-o", out_path,
           "--device", device, "--ml"]
    try:
        process = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
    except FileNotFoundError:
        return False, "TotalSegmentator command not found"
    _register_pid(process.pid)
    try:
        _stdout, stderr = process.communicate(timeout=timeout)
        kill_process_tree(process.pid)
        if process.returncode != 0:
            return False, (f"TotalSegmentator error "
                           f"(code {process.returncode}): {stderr[-200:]}")
        return True, None
    except subprocess.TimeoutExpired:
        kill_process_tree(process.pid)
        return False, "TotalSegmentator timeout"
    finally:
        _unregister_pid(process.pid)


def segment_patient(task) -> Tuple[str, bool, Optional[str]]:
    """Pool worker: DICOM -> NIfTI -> TotalSegmentator
    (masking.py:205-299)."""
    patient_dir, working_patient_dir, masked_patient_dir, device = task
    patient_id = os.path.basename(os.path.dirname(patient_dir)) or \
        os.path.basename(patient_dir)
    if os.path.exists(f"{masked_patient_dir}.nii"):
        return (patient_id, True, None)
    os.makedirs(working_patient_dir, exist_ok=True)
    nifti_path = os.path.join(working_patient_dir, "input.nii.gz")
    if not dicom_to_nifti(patient_dir, nifti_path):
        return (patient_id, False, "Failed to convert DICOM to NIfTI")
    ok, err = run_totalsegmentator(nifti_path, masked_patient_dir,
                                   device=device)
    return (patient_id, ok, err)


# 2-D structures with a zero z extent: every (z, y, x) call below works
# slice by slice, all slices at once (ndimage.label wants 3 planes, the
# outer two empty)
_CROSS = np.zeros((3, 3, 3), bool)
_CROSS[1] = ndimage.generate_binary_structure(2, 1)
_SQUARE = np.ones((1, 3, 3), bool)
_yy, _xx = np.mgrid[-2:3, -2:3]
_DISK2 = (_yy ** 2 + _xx ** 2 <= 4)[None]


def _filled(mask: np.ndarray) -> np.ndarray:
    """Each slice of ``mask`` with its holes filled: what drawing its
    external contours filled gives. A hole is a background component
    (4-connected within the slice) that touches no edge of the slice;
    ``ndimage.binary_fill_holes`` with the same structure, by labelling."""
    lab, n = ndimage.label(~mask, structure=_CROSS)
    edge = np.zeros(n + 1, bool)
    for side in (lab[:, 0], lab[:, -1], lab[:, :, 0], lab[:, :, -1]):
        edge[side] = True
    edge[0] = False
    return ~edge[lab]


def _rim(mask: np.ndarray) -> np.ndarray:
    """Each slice's 8-connected inner boundary."""
    return mask & ~ndimage.binary_erosion(mask, structure=_SQUARE,
                                          border_value=0)


def build_exclusion_mask(label_volume: np.ndarray,
                         labels: List[int] = MASK_TARGET_LABELS
                         ) -> np.ndarray:
    """Multi-label volume (z, y, x) -> binary exclusion mask
    (masking.py:455-512), in morphology in place of cv2's contours:

      - each label's external contours drawn filled = the label with its
        holes filled;
      - the same contours drawn 2 px thick = its filled mask's inner
        boundary dilated by a 3x3 square;
      - the union's outer contours drawn 4 px thick = the filled union's
        inner boundary dilated by the disk x^2 + y^2 <= 4 (RETR_EXTERNAL
        traces no hole of the union).

    Every slice at once: one pass per label present, on the label's
    bounding box grown by the 1 px its dilation reaches and the 1 px that
    keeps its outside connected; the last pass on the union's box grown
    by 3. The only pixels this moves against
    the contour drawing lie on the rim (cv2 draws a thick contour as
    polygon lines between the simplified chain's vertices):
    ``tests/test_torch_masking.py`` holds the interiors exact and the rest
    to 99.9% of pixels, within 2 px of the rim."""
    label_volume = np.asarray(label_volume)
    out = np.zeros(label_volume.shape, bool)
    _, h, w = label_volume.shape

    def grown(box, by):
        zs, ys, xs = box
        return (zs, slice(max(ys.start - by, 0), min(ys.stop + by, h)),
                slice(max(xs.start - by, 0), min(xs.stop + by, w)))

    boxes = ndimage.find_objects(np.maximum(label_volume, 0).astype(np.intp))
    for label in np.intersect1d(np.unique(label_volume), labels):
        box = grown(boxes[int(label) - 1], 2)
        filled = _filled(label_volume[box] == label)
        out[box] |= filled | ndimage.binary_dilation(_rim(filled),
                                                     structure=_SQUARE)
    if out.any():
        box = grown(ndimage.find_objects(out.astype(np.int8))[0], 3)
        out[box] |= ndimage.binary_dilation(_rim(_filled(out[box])),
                                            structure=_DISK2)
    return out.astype(np.uint8)


def apply_exclusion_mask(dcm_paths: List[str], mask_volume: np.ndarray,
                         out_dir: str):
    """Set masked pixels to 9999, write Explicit VR Little Endian int16
    MONOCHROME2, save under out_dir (masking.py:518-560).

    ``set_pixel_array`` sets the int16 pixel tags and resets the transfer
    syntax, so a compressed source is written framed as what its new
    pixels are (the JAX function swaps PixelData under the encapsulated
    syntax and cannot save it)."""
    from ducosy_tpu_torch.dicom import dcmread

    os.makedirs(out_dir, exist_ok=True)
    for idx, path in enumerate(dcm_paths):
        ds = dcmread(path)
        px = ds.pixel_array.copy().astype(np.int16)
        px[mask_volume[idx] != 0] = MASK_FILL_VALUE
        ds.set_pixel_array(px)
        if ds.get("PhotometricInterpretation") in ("YBR_FULL_422",
                                                   "YBR_FULL"):
            ds.PhotometricInterpretation = "MONOCHROME2"
        ds.save_as(os.path.join(out_dir, os.path.basename(path)))
