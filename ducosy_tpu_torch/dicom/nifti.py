"""Minimal NIfTI-1 codec (read/write, uncompressed and .gz): the port's copy
of ducosy_tpu/dicom/nifti.py.

The reference uses nibabel for the TotalSegmentator masking pipeline
(masking.py:104-202 builds NIfTI volumes from DICOM with a hand-rolled
affine; modify_heart_mask.py loads/saves multi-label NIfTIs). The package
ships the subset it needs: single-file .nii / .nii.gz, int/float dtypes,
affine via srow matrix. ``tests/test_torch_masking.py`` holds each package
to reading the other's files.
"""
from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC = b"n+1\x00"

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (data, affine). Data keeps the on-disk axis order (x, y, z)."""
    with _open(path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError("truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"unsupported NIfTI (sizeof_hdr={sizeof_hdr})")
        dim = struct.unpack_from("<8h", hdr, 40)
        datatype = struct.unpack_from("<h", hdr, 70)[0]
        vox_offset = struct.unpack_from("<f", hdr, 108)[0]
        scl_slope = struct.unpack_from("<f", hdr, 112)[0]
        scl_inter = struct.unpack_from("<f", hdr, 116)[0]
        srow = np.array(struct.unpack_from("<12f", hdr, 280),
                        np.float64).reshape(3, 4)
        affine = np.vstack([srow, [0, 0, 0, 1]])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1:1 + max(ndim, 1)])
        dtype = _DTYPES.get(datatype)
        if dtype is None:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        f.seek(int(vox_offset))
        count = int(np.prod(shape)) if shape else 0
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                             dtype=dtype, count=count)
        data = data.reshape(shape, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            data = data.astype(np.float32) * slope + scl_inter
        return data, affine


def write_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None,
                *, voxel_sizes: Tuple[float, float, float] | None = None):
    """Write a 3-D (or 2-D) array in Fortran (x,y,z) order with the given
    affine (defaults to identity scaled by voxel_sizes)."""
    data = np.asarray(data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = _CODES[np.dtype(np.float32)]
    if affine is None:
        vs = voxel_sizes or (1.0, 1.0, 1.0)
        affine = np.diag([vs[0], vs[1], vs[2], 1.0])
    affine = np.asarray(affine, np.float64)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i]))
                      for i in range(min(3, ndim))]
    pixdim += [1.0] * (8 - len(pixdim))
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 1)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = _MAGIC

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))


def dicom_affine(pixel_spacing, slice_thickness, first_position,
                 orientation=None) -> np.ndarray:
    """Hand-rolled DICOM->NIfTI affine matching the reference's construction
    (masking.py:104-202): row/col spacing on the diagonal, slice thickness on
    z, ImagePositionPatient of the first slice as the translation."""
    aff = np.eye(4)
    aff[0, 0] = float(pixel_spacing[0])
    aff[1, 1] = float(pixel_spacing[1])
    aff[2, 2] = float(slice_thickness)
    aff[:3, 3] = np.asarray(first_position, np.float64)
    return aff
