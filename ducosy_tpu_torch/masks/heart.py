"""Heart-label (TotalSegmentator class 51) mask cleanup: the port's copy of
ducosy_tpu/masks/heart.py (numpy and scipy only).

Rebuild of modify_heart_mask.py:87-212: removes vessel tails from the heart
label by (1) cutting along z after >=2-slice gaps per (x, y) column,
(2) pruning voxels beyond an anisotropic distance from the lowest-z
cluster centroid (offsets 1.15 / variable-y 1.4 / z 2.65), and (3) dropping
connected components under 1024 voxels. Operates on (x, y, z) volumes as
loaded from NIfTI.

The per-(x,y)-column z-gap cut — a triple Python loop in the reference
(modify_heart_mask.py:111-123) — is vectorized here with a cumulative-run
formulation (same result, orders of magnitude faster on 512^3 volumes).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

HEART_LABEL = 51
GAP_THRESHOLD = 2
REGION_SIZE_THRESHOLD = 1024
OFFSET = 1.15
OFFSET_Y_BASE = 1.4
OFFSET_Z = 2.65


def _z_gap_cut(heart: np.ndarray, start_z: int,
               gap_threshold: int = GAP_THRESHOLD) -> np.ndarray:
    """For every (x, y) column, zero all z >= the first run of
    `gap_threshold` consecutive empty voxels at/after start_z."""
    x, y, zdim = heart.shape
    sub = heart[:, :, start_z:] > 0
    # run length of consecutive zeros ending at each z
    runs = np.zeros_like(sub, dtype=np.int32)
    run = np.zeros((x, y), dtype=np.int32)
    out = heart.copy()
    cut = np.full((x, y), zdim, dtype=np.int32)  # absolute cut z per column
    done = np.zeros((x, y), dtype=bool)
    for dz in range(sub.shape[2]):
        run = np.where(sub[:, :, dz], 0, run + 1)
        hit = (~done) & (run >= gap_threshold)
        # cut position: z - gap_count + 1 in reference indexing
        cut[hit] = start_z + dz - gap_threshold + 1
        done |= hit
    zz = np.arange(zdim)[None, None, :]
    out[zz >= cut[:, :, None]] = 0
    return out


def modify_heart_mask_volume(mask_volume: np.ndarray) -> np.ndarray:
    """Clean label 51 inside a multi-label (x, y, z) volume; returns a new
    volume with the heart label replaced by its cleaned version."""
    mask_volume = mask_volume.astype(np.uint8).copy()
    heart = (mask_volume == HEART_LABEL).astype(np.uint8)
    if heart.sum() == 0:
        return mask_volume

    labeled, n = ndimage.label(heart)
    centers = ndimage.center_of_mass(heart, labeled, range(1, n + 1))
    centers = sorted(centers, key=lambda c: c[2])

    if centers:
        start_z = int(centers[0][2])
        heart = _z_gap_cut(heart, start_z)

        x, y, z = centers[0]
        cur_slice = heart[:, :, int(z)]
        ni, nj = np.nonzero(cur_slice)
        if len(ni) > 0:
            max_distance = np.max(np.sqrt((ni - x) ** 2 + (nj - y) ** 2)) \
                * OFFSET
            ii, jj, kk = np.nonzero(heart)
            xd = ii - x
            yd = jj - y
            zd = kk - z
            off_y = 1 + (OFFSET_Y_BASE - 1) * np.abs(xd) / (
                np.max(np.abs(xd)) + 1e-5)
            dist = np.sqrt(
                xd ** 2
                + np.where((yd > 0) & (zd > 0), (yd * off_y) ** 2, yd ** 2)
                + np.where(zd > 0, (zd * OFFSET_Z) ** 2, zd ** 2))
            remove = dist >= max_distance
            heart[ii[remove], jj[remove], kk[remove]] = 0

    labeled, n = ndimage.label(heart)
    if n:
        sizes = ndimage.sum_labels(heart, labeled, range(1, n + 1))
        small = np.zeros(n + 1, dtype=bool)
        small[1:] = sizes < REGION_SIZE_THRESHOLD
        heart[small[labeled]] = 0

    mask_volume[mask_volume == HEART_LABEL] = 0
    mask_volume[heart == 1] = HEART_LABEL
    return mask_volume


def modify_heart_mask_file(mask_path: str, modified_mask_path: str):
    """NIfTI in -> cleaned NIfTI out (modify_heart_mask.py:89-212)."""
    from ducosy_tpu_torch.dicom.nifti import read_nifti, write_nifti

    data, affine = read_nifti(mask_path)
    out = modify_heart_mask_volume(np.asarray(data).astype(np.uint8))
    write_nifti(modified_mask_path, out, affine)
