"""ctypes bindings to the native DICOM parser (native/dicom_codec.cc).

`read_slice(path)` parses one CT slice: a single C pass over the mmapped
bytes extracts geometry/rescale/order tags and the pixel-data extent, and the
pixel array is a zero-copy numpy view over the file buffer.

The library is built at first use with the host C++ compiler ($CXX, c++ or
g++) from ``native/dicom_codec.cc`` of the checkout into the git-ignored
``ducosy_tpu_torch/_build/``, named by a hash of the source. Where the
source or a compiler is missing, or the build fails, every caller keeps the
pure-Python codec, which gives the same arrays. This is host parsing, not a
device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "dicom_codec.cc"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def build() -> Optional[Path]:
    """Compile ``native/dicom_codec.cc`` unless already built; the library's
    path, or None where the source or a compiler is missing or the build
    fails (the compiler's output is kept beside it as ``.log``)."""
    if not SOURCE.is_file():
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    lib = BUILD_DIR / f"libdicom_native-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = next((c for c in (os.environ.get("CXX"), "c++", "g++")
                if c and shutil.which(c)), None)
    if cxx is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


class _SliceMeta(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("bits_allocated", ctypes.c_int32),
        ("pixel_representation", ctypes.c_int32),
        ("instance_number", ctypes.c_int32),
        ("has_pixels", ctypes.c_int32),
        ("rescale_slope", ctypes.c_double),
        ("rescale_intercept", ctypes.c_double),
        ("slice_location", ctypes.c_double),
        ("ipp_z", ctypes.c_double),
        ("pixel_offset", ctypes.c_uint64),
        ("pixel_length", ctypes.c_uint64),
    ]


_lib = None
_tried = False
_lock = threading.Lock()


def available() -> bool:
    """True once the library is built and loaded; builds it at the first
    call (one attempt per process)."""
    global _lib, _tried
    if _lib is not None:
        return True
    with _lock:
        if not _tried:
            _tried = True
            _load()
    return _lib is not None


def _load() -> None:
    global _lib
    path = build()
    if path is None:
        return
    try:
        lib = ctypes.CDLL(str(path))
        lib.parse_slice.restype = ctypes.c_int
        lib.parse_slice.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.POINTER(_SliceMeta)]
        if hasattr(lib, "decode_jpeg_sv1"):  # older .so builds lack it
            lib.decode_jpeg_sv1.restype = ctypes.c_int
            lib.decode_jpeg_sv1.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except OSError:  # pragma: no cover
        pass


def jpeg_sv1_decode_native(data: bytes):
    """Native JPEG Lossless SV1 decode (the fast path of the pure-Python
    decoder in ``compressed.py``).

    Returns (uint16 array (rows, cols), precision), or None when the
    native library is unavailable / lacks the symbol / rejects the stream
    (malformed or out-of-profile) — compressed.jpeg_sv1_decode calls this
    first and the pure-Python decoder handles every None, so error
    messages and edge-case coverage are identical either way."""
    if not available() or not hasattr(_lib, "decode_jpeg_sv1"):
        return None
    # capacity from the SOF3 header would need a pre-parse; CT slices are
    # bounded — retry once with the actual geometry if the guess is short
    cap = 4096 * 4096
    out = np.empty(cap, np.uint16)
    rows = ctypes.c_int32()
    cols = ctypes.c_int32()
    prec = ctypes.c_int32()
    rc = _lib.decode_jpeg_sv1(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
        ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(prec))
    if rc != 0:
        # malformed (1) or out-of-profile (3): let the pure-Python decoder
        # produce its detailed error (or handle a case the native path
        # doesn't) — identical user-facing semantics either way
        return None
    n = rows.value * cols.value
    return out[:n].reshape(rows.value, cols.value).copy(), prec.value


class SliceInfo:
    __slots__ = ("pixels", "rows", "cols", "rescale_slope",
                 "rescale_intercept", "instance_number", "slice_location",
                 "ipp_z", "pixel_representation")

    def __init__(self, meta: _SliceMeta, pixels: Optional[np.ndarray]):
        self.pixels = pixels
        self.rows = meta.rows
        self.cols = meta.cols
        self.rescale_slope = meta.rescale_slope
        self.rescale_intercept = meta.rescale_intercept
        self.instance_number = meta.instance_number
        self.slice_location = meta.slice_location
        self.ipp_z = meta.ipp_z
        self.pixel_representation = meta.pixel_representation


def read_slice(path: str, *, pixels: bool = True) -> SliceInfo:
    """Parse one slice natively. Raises ValueError on malformed input and
    NotImplementedError on compressed transfer syntaxes (codec parity)."""
    if not available():
        raise RuntimeError(
            "native DICOM parser not available (no native/dicom_codec.cc "
            "beside the package, no C++ compiler, or the build failed)")
    data = np.fromfile(path, dtype=np.uint8)
    meta = _SliceMeta()
    status = _lib.parse_slice(
        data.ctypes.data_as(ctypes.c_char_p), data.size,
        ctypes.byref(meta))
    if status == 2:
        raise NotImplementedError(f"unsupported transfer syntax in {path}")
    if status != 0:
        raise ValueError(f"malformed DICOM stream: {path}")
    if pixels and not meta.has_pixels:
        raise ValueError(f"no PixelData in {path}")
    arr = None
    if pixels and meta.has_pixels:
        bits = meta.bits_allocated
        signed = meta.pixel_representation == 1
        dtype = {8: (np.int8 if signed else np.uint8),
                 16: (np.int16 if signed else np.uint16)}.get(bits)
        if dtype is None:
            raise ValueError(f"unsupported BitsAllocated={bits}")
        count = meta.rows * meta.cols
        start = int(meta.pixel_offset)
        arr = data[start:start + count * np.dtype(dtype).itemsize] \
            .view(dtype)[:count].reshape(meta.rows, meta.cols)
    return SliceInfo(meta, arr)


def read_slice_any(path: str, *, pixels: bool = True):
    """Native fast path with pure-Python fallback; returns an object with
    SliceInfo's fields either way."""
    if available():
        try:
            return read_slice(path, pixels=pixels)
        except NotImplementedError:
            # compressed transfer syntax (native status 2): the Python
            # codec decodes RLE Lossless / JPEG Lossless SV1 itself
            pass
    from ducosy_tpu_torch.dicom.codec import dcmread

    ds = dcmread(path, stop_before_pixels=not pixels)
    info = _SliceMeta()
    info.rows = int(ds.get("Rows", 0) or 0)
    info.cols = int(ds.get("Columns", 0) or 0)
    info.rescale_slope = float(ds.get("RescaleSlope", 1.0) or 1.0)
    info.rescale_intercept = float(ds.get("RescaleIntercept", 0.0) or 0.0)
    info.instance_number = int(ds.get("InstanceNumber", 0) or 0)
    info.slice_location = float(ds.get("SliceLocation", 0.0) or 0.0)
    ipp = ds.get("ImagePositionPatient", [0.0, 0.0, 0.0])
    info.ipp_z = float(ipp[2]) if isinstance(ipp, list) and len(ipp) >= 3 \
        else 0.0
    info.pixel_representation = int(ds.get("PixelRepresentation", 0) or 0)
    return SliceInfo(info, ds.pixel_array if pixels else None)
