"""Self-contained DICOM codec (read + write, uncompressed little-endian).

The reference pipeline leans on pydicom for every stage (dataset pairing,
HU rescale tags, inference writeback with tag surgery — e.g.
modules/dataset.py:82-90, generate.py:107-126,266-297). This environment has
no pydicom, so the framework ships its own codec covering what a CT pipeline
needs:

  - read: Implicit VR LE (1.2.840.10008.1.2) and Explicit VR LE
    (1.2.840.10008.1.2.1), including skipping/retaining sequences verbatim
    so unknown structures round-trip byte-exactly.
  - write: Explicit VR LE with regenerated file meta (the reference also
    forces ExplicitVRLittleEndian on output, generate.py:109).
  - numpy pixel decode/encode for 8/16-bit mono images, signed or unsigned
    (PixelRepresentation), with RescaleSlope/Intercept left to callers.

Compressed lossless syntaxes decode natively: RLE Lossless
(1.2.840.10008.1.2.5), JPEG Lossless SV1 (1.2.840.10008.1.2.4.70) and the
general JPEG Lossless Process 14 (1.2.840.10008.1.2.4.57, predictors
1-7) — the syntaxes the reference handles through its python-rle /
pylibjpeg wheels (the reference's requirements.txt) that actually occur
in lossless CT archives (see ducosy_tpu_torch/dicom/compressed.py). Lossy
families (JPEG baseline, J2K) raise with a clear message.

An optional C++ fast path for bulk parsing lives in ducosy_tpu_torch/dicom/native.py.
"""
from __future__ import annotations

import io
import os
import struct
from typing import Any, Dict, Iterator, Tuple

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
# encapsulated syntaxes this codec decodes itself (the reference gets the
# same coverage from the python-rle / pylibjpeg wheels it installs —
# the reference's requirements.txt); lossy families stay rejected
_ENCAPSULATED = (RLE_LOSSLESS, JPEG_LOSSLESS_SV1, JPEG_LOSSLESS_P14)
_SUPPORTED = (IMPLICIT_VR_LE, EXPLICIT_VR_LE)

# VRs with 4-byte lengths (and a 2-byte reserved field) in explicit VR
# VRs using the 12-byte explicit form (2 reserved bytes + 32-bit length),
# PS3.5 Table 7.1-1 — includes the 64-bit SV/UV added in the 2019 edition
_LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "OV", "SQ", "SV", "UC", "UN",
             "UR", "UT", "UV"}
# every VR code of PS3.5 §6.2 — explicit-VR parsing rejects anything else
# (garbage bytes would otherwise parse as empty elements and round-trip)
_ALL_VRS = _LONG_VRS | {
    "AE", "AS", "AT", "CS", "DA", "DS", "DT", "FL", "FD", "IS", "LO", "LT",
    "PN", "SH", "SL", "SS", "ST", "TM", "UI", "UL", "US",
}
_UNDEFINED = 0xFFFFFFFF

Tag = Tuple[int, int]

# Keyword dictionary: the tags this pipeline touches. (tag): (VR, keyword)
DICT: Dict[Tag, Tuple[str, str]] = {
    (0x0002, 0x0000): ("UL", "FileMetaInformationGroupLength"),
    (0x0002, 0x0001): ("OB", "FileMetaInformationVersion"),
    (0x0002, 0x0002): ("UI", "MediaStorageSOPClassUID"),
    (0x0002, 0x0003): ("UI", "MediaStorageSOPInstanceUID"),
    (0x0002, 0x0010): ("UI", "TransferSyntaxUID"),
    (0x0002, 0x0012): ("UI", "ImplementationClassUID"),
    (0x0002, 0x0013): ("SH", "ImplementationVersionName"),
    (0x0008, 0x0008): ("CS", "ImageType"),
    (0x0008, 0x0016): ("UI", "SOPClassUID"),
    (0x0008, 0x0018): ("UI", "SOPInstanceUID"),
    (0x0008, 0x0020): ("DA", "StudyDate"),
    (0x0008, 0x0021): ("DA", "SeriesDate"),
    (0x0008, 0x0022): ("DA", "AcquisitionDate"),
    (0x0008, 0x0023): ("DA", "ContentDate"),
    (0x0008, 0x0030): ("TM", "StudyTime"),
    (0x0008, 0x0031): ("TM", "SeriesTime"),
    (0x0008, 0x0032): ("TM", "AcquisitionTime"),
    (0x0008, 0x0033): ("TM", "ContentTime"),
    (0x0008, 0x0050): ("SH", "AccessionNumber"),
    (0x0008, 0x0060): ("CS", "Modality"),
    (0x0008, 0x0070): ("LO", "Manufacturer"),
    (0x0008, 0x0080): ("LO", "InstitutionName"),
    (0x0008, 0x0081): ("ST", "InstitutionAddress"),
    (0x0008, 0x0090): ("PN", "ReferringPhysicianName"),
    (0x0008, 0x1030): ("LO", "StudyDescription"),
    (0x0008, 0x103E): ("LO", "SeriesDescription"),
    (0x0008, 0x1040): ("LO", "InstitutionalDepartmentName"),
    (0x0008, 0x1050): ("PN", "PerformingPhysicianName"),
    (0x0008, 0x1070): ("PN", "OperatorsName"),
    (0x0010, 0x0010): ("PN", "PatientName"),
    (0x0010, 0x0020): ("LO", "PatientID"),
    (0x0010, 0x0030): ("DA", "PatientBirthDate"),
    (0x0010, 0x0040): ("CS", "PatientSex"),
    (0x0010, 0x1010): ("AS", "PatientAge"),
    (0x0010, 0x1020): ("DS", "PatientSize"),
    (0x0010, 0x1030): ("DS", "PatientWeight"),
    (0x0018, 0x0050): ("DS", "SliceThickness"),
    (0x0018, 0x0060): ("DS", "KVP"),
    (0x0018, 0x5100): ("CS", "PatientPosition"),
    (0x0020, 0x000D): ("UI", "StudyInstanceUID"),
    (0x0020, 0x000E): ("UI", "SeriesInstanceUID"),
    (0x0020, 0x0010): ("SH", "StudyID"),
    (0x0020, 0x0011): ("IS", "SeriesNumber"),
    (0x0020, 0x0013): ("IS", "InstanceNumber"),
    (0x0020, 0x0032): ("DS", "ImagePositionPatient"),
    (0x0020, 0x0037): ("DS", "ImageOrientationPatient"),
    (0x0020, 0x1041): ("DS", "SliceLocation"),
    (0x0028, 0x0002): ("US", "SamplesPerPixel"),
    (0x0028, 0x0004): ("CS", "PhotometricInterpretation"),
    (0x0028, 0x0010): ("US", "Rows"),
    (0x0028, 0x0011): ("US", "Columns"),
    (0x0028, 0x0030): ("DS", "PixelSpacing"),
    (0x0028, 0x0100): ("US", "BitsAllocated"),
    (0x0028, 0x0101): ("US", "BitsStored"),
    (0x0028, 0x0102): ("US", "HighBit"),
    (0x0028, 0x0103): ("US", "PixelRepresentation"),
    (0x0028, 0x0106): ("US", "SmallestImagePixelValue"),
    (0x0028, 0x0107): ("US", "LargestImagePixelValue"),
    (0x0028, 0x1050): ("DS", "WindowCenter"),
    (0x0028, 0x1051): ("DS", "WindowWidth"),
    (0x0028, 0x1052): ("DS", "RescaleIntercept"),
    (0x0028, 0x1053): ("DS", "RescaleSlope"),
    (0x0028, 0x1054): ("LO", "RescaleType"),
    (0x7FE0, 0x0010): ("OW", "PixelData"),
}
KEYWORD_TO_TAG = {kw: tag for tag, (_, kw) in DICT.items()}
TAG_TO_VR = {tag: vr for tag, (vr, _) in DICT.items()}

_STRING_VRS = {"AE", "AS", "CS", "DA", "DS", "DT", "IS", "LO", "LT", "PN",
               "SH", "ST", "TM", "UC", "UI", "UR", "UT"}
_BINARY_FMT = {"US": "<H", "SS": "<h", "UL": "<I", "SL": "<i",
               "FL": "<f", "FD": "<d"}


class Element:
    """One data element: tag, VR, raw little-endian value bytes."""

    __slots__ = ("tag", "vr", "raw")

    def __init__(self, tag: Tag, vr: str, raw: bytes):
        self.tag = tag
        self.vr = vr
        self.raw = raw

    def value(self) -> Any:
        """Decode to python value(s); multi-valued elements -> list."""
        vr, raw = self.vr, self.raw
        if vr in _STRING_VRS:
            s = raw.decode("latin-1").rstrip("\x00 ")
            if vr in ("DS", "IS") or "\\" in s:
                parts = [p.strip() for p in s.split("\\")]
                vals = []
                for p in parts:
                    if vr == "DS":
                        vals.append(float(p) if p else 0.0)
                    elif vr == "IS":
                        vals.append(int(p) if p else 0)
                    else:
                        vals.append(p)
                return vals[0] if len(vals) == 1 else vals
            return s
        fmt = _BINARY_FMT.get(vr)
        if fmt is not None:
            size = struct.calcsize(fmt)
            n = len(raw) // size
            vals = [struct.unpack_from(fmt, raw, i * size)[0]
                    for i in range(n)]
            return vals[0] if len(vals) == 1 else vals
        return raw  # OB/OW/SQ/UN and friends stay raw

    def __repr__(self):
        kw = DICT.get(self.tag, ("", "?"))[1]
        return (f"Element({self.tag[0]:04X},{self.tag[1]:04X}) {self.vr} "
                f"{kw} len={len(self.raw)}")


def _encode_value(vr: str, value: Any) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
    elif vr in _STRING_VRS:
        if isinstance(value, (list, tuple)):
            parts = []
            for v in value:
                if vr == "DS" and isinstance(v, float):
                    parts.append(_format_ds(v))
                else:
                    parts.append(str(v))
            s = "\\".join(parts)
        elif vr == "DS" and isinstance(value, float):
            s = _format_ds(value)
        else:
            s = str(value)
        raw = s.encode("latin-1")
    else:
        fmt = _BINARY_FMT.get(vr)
        if fmt is None:
            raise ValueError(f"cannot encode VR {vr} from {type(value)}")
        if isinstance(value, (list, tuple)):
            raw = b"".join(struct.pack(fmt, v) for v in value)
        else:
            raw = struct.pack(fmt, value)
    if len(raw) % 2:
        raw += b"\x00" if vr in ("UI", "OB", "UN") else b" "
    return raw


def _format_ds(v: float) -> str:
    """Decimal string <= 16 chars."""
    s = repr(float(v))
    if len(s) > 16:
        s = f"{v:.10g}"
    return s[:16]


class Dataset:
    """Ordered tag -> Element map with pydicom-style attribute access for
    dictionary keywords (ds.Rows, ds.RescaleSlope, ds.PixelData, ...)."""

    def __init__(self):
        object.__setattr__(self, "_elements", {})
        object.__setattr__(self, "transfer_syntax_uid", EXPLICIT_VR_LE)
        if type(self) is Dataset:
            object.__setattr__(self, "file_meta", Meta())

    # --- element-level API ---
    def set(self, tag: Tag, vr: str, value: Any):
        self._elements[tag] = Element(tag, vr, _encode_value(vr, value))

    def set_raw(self, tag: Tag, vr: str, raw: bytes):
        self._elements[tag] = Element(tag, vr, raw)

    def get_element(self, tag: Tag) -> Element | None:
        return self._elements.get(tag)

    def delete(self, tag: Tag):
        self._elements.pop(tag, None)

    def tags(self) -> Iterator[Tag]:
        return iter(sorted(self._elements))

    def add_new(self, tag, vr: str, value: Any):
        """pydicom-compatible: ds.add_new((0x0028,0x0106), 'US', v)
        (generate.py:282-283)."""
        self.set((int(tag[0]), int(tag[1])), vr, value)

    def __contains__(self, keyword: str) -> bool:
        tag = KEYWORD_TO_TAG.get(keyword)
        return tag is not None and tag in self._elements

    # --- attribute-style access ---
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        tag = KEYWORD_TO_TAG.get(name)
        if tag is None:
            raise AttributeError(name)
        el = self._elements.get(tag)
        if el is None:
            raise AttributeError(f"{name} not present")
        return el.value()

    def __setattr__(self, name: str, value: Any):
        if name in ("file_meta", "transfer_syntax_uid"):
            object.__setattr__(self, name, value)
            return
        tag = KEYWORD_TO_TAG.get(name)
        if tag is None:
            object.__setattr__(self, name, value)
            return
        el = self._elements.get(tag)
        vr = el.vr if el is not None else TAG_TO_VR[tag]
        self.set(tag, vr, value)

    def __delattr__(self, name: str):
        tag = KEYWORD_TO_TAG.get(name)
        if tag is not None:
            self.delete(tag)
        else:
            object.__delattr__(self, name)

    def get(self, keyword: str, default=None):
        try:
            return getattr(self, keyword)
        except AttributeError:
            return default

    # --- pixels ---
    @property
    def pixel_array(self) -> np.ndarray:
        el = self._elements.get((0x7FE0, 0x0010))
        if el is None:
            raise AttributeError("no PixelData")
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        rows = self.get("Rows")
        cols = self.get("Columns")
        if rows is None or cols is None:
            # NOT AttributeError: a property getter's AttributeError is
            # swallowed by Python's __getattr__ fallback and resurfaces as
            # a message-less AttributeError('pixel_array')
            raise ValueError("PixelData present but Rows/Columns missing "
                             "(corrupt geometry tags)")
        rows, cols = int(rows), int(cols)
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        else:
            raise ValueError(f"unsupported BitsAllocated={bits}")
        if self.transfer_syntax_uid in _ENCAPSULATED:
            return self._decode_encapsulated(el.raw, rows, cols, bits,
                                             dtype)
        n = rows * cols
        arr = np.frombuffer(el.raw, dtype=dtype, count=n)
        return arr.reshape(rows, cols)

    def _decode_encapsulated(self, raw: bytes, rows: int, cols: int,
                             bits: int, dtype) -> np.ndarray:
        from ducosy_tpu_torch.dicom import compressed as _c

        nframes = int(self.get("NumberOfFrames", 1) or 1)
        if nframes != 1:
            raise NotImplementedError(
                f"multi-frame compressed PixelData (NumberOfFrames="
                f"{nframes}) is out of scope for single-slice CT series")
        _offsets, fragments = _c.parse_encapsulated(raw)
        if self.transfer_syntax_uid == RLE_LOSSLESS:
            if len(fragments) != 1:
                # PS3.5 G.1: RLE requires exactly one fragment per frame
                raise ValueError(
                    f"RLE frame split across {len(fragments)} fragments")
            arr = _c.rle_decode_frame(fragments[0], rows, cols, bits)
        else:  # JPEG Lossless; a frame may span several fragments
            arr, precision = _c.jpeg_sv1_decode(b"".join(fragments))
            if precision > bits:
                raise ValueError(
                    f"JPEG precision {precision} exceeds BitsAllocated="
                    f"{bits}")
            if bits == 8:
                arr = arr.astype(np.uint8)
        if arr.shape != (rows, cols):
            raise ValueError(
                f"compressed frame decodes to {arr.shape}, but "
                f"Rows/Columns say {(rows, cols)}")
        return arr.view(dtype)

    def set_pixel_array(self, arr: np.ndarray):
        """Replace PixelData and geometry tags from a 2-D numpy array."""
        arr = np.ascontiguousarray(arr)
        self.Rows = int(arr.shape[0])
        self.Columns = int(arr.shape[1])
        self.BitsAllocated = int(arr.dtype.itemsize * 8)
        self.BitsStored = int(arr.dtype.itemsize * 8)
        self.HighBit = int(arr.dtype.itemsize * 8 - 1)
        self.PixelRepresentation = 1 if arr.dtype.kind == "i" else 0
        self.set_raw((0x7FE0, 0x0010), "OW", arr.tobytes())
        # the new pixels are native bytes: a dataset read from a compressed
        # series must not keep its encapsulated syntax, or dcmwrite would
        # take its no-transcode branch and write them unframed under it
        self.transfer_syntax_uid = EXPLICIT_VR_LE

    @property
    def PixelData(self) -> bytes:  # noqa: N802 — pydicom-compatible name
        el = self._elements.get((0x7FE0, 0x0010))
        return None if el is None else el.raw

    @PixelData.setter
    def PixelData(self, raw: bytes):  # noqa: N802
        data = bytes(raw)
        if len(data) % 2:
            data += b"\x00"
        self.set_raw((0x7FE0, 0x0010), "OW", data)

    def copy(self) -> "Dataset":
        ds = Dataset()
        for tag, el in self._elements.items():
            ds.set_raw(tag, el.vr, el.raw)
        ds.file_meta = self.file_meta.copy()
        ds.transfer_syntax_uid = self.transfer_syntax_uid
        return ds

    def save_as(self, path: str):
        dcmwrite(path, self)


class Meta(Dataset):
    """File meta information group (0002)."""

    def copy(self) -> "Meta":
        m = Meta()
        for tag, el in self._elements.items():
            m.set_raw(tag, el.vr, el.raw)
        return m


# ---------------------------------------------------------------- reading
def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated DICOM stream")
    return b


def _scan_sequence(f) -> bytes:
    """Consume an undefined-length SQ value, returning the raw bytes
    (items + delimiter) verbatim for round-tripping."""
    out = io.BytesIO()
    while True:
        head = _read_exact(f, 8)
        group, elem, length = struct.unpack("<HHI", head)
        out.write(head)
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return out.getvalue()
        if (group, elem) == (0xFFFE, 0xE000) and length == _UNDEFINED:
            # undefined-length item: copy until item delimiter
            while True:
                ihead = _read_exact(f, 8)
                igroup, ielem, ilen = struct.unpack("<HHI", ihead)
                out.write(ihead)
                if (igroup, ielem) == (0xFFFE, 0xE00D):
                    break
                if (igroup, ielem) == (0xFFFE, 0xE000) or ilen == _UNDEFINED:
                    raise ValueError("nested undefined-length item")
                out.write(_read_exact(f, ilen))
        else:
            out.write(_read_exact(f, length))


def _read_element(f, explicit: bool) -> Element | None:
    head = f.read(8)
    if len(head) < 8:
        return None
    group, elem = struct.unpack_from("<HH", head)
    tag = (group, elem)
    if explicit:
        vr = head[4:6].decode("ascii", "replace")
        if vr not in _ALL_VRS:
            raise ValueError(
                f"invalid VR {vr!r} at tag {tag} — not an explicit-VR "
                "DICOM stream")
        if vr in _LONG_VRS:
            length = struct.unpack("<I", _read_exact(f, 4))[0]
        else:
            length = struct.unpack_from("<H", head, 6)[0]
    else:
        length = struct.unpack_from("<I", head, 4)[0]
        vr = TAG_TO_VR.get(tag, "UN")
    if length == _UNDEFINED:
        raw = _scan_sequence(f)
        return Element(tag, "SQ" if vr in ("UN", "SQ") else vr, raw)
    return Element(tag, vr, _read_exact(f, length))


def dcmread(path_or_bytes, *, stop_before_pixels: bool = False) -> Dataset:
    """Read a DICOM Part-10 file (or raw dataset bytes without preamble)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    try:
        ds = Dataset()
        start = f.read(132)
        if len(start) >= 132 and start[128:132] == b"DICM":
            pass  # positioned after magic
        else:
            f.seek(0)  # headerless stream: assume explicit VR LE dataset
            ds.transfer_syntax_uid = EXPLICIT_VR_LE
            _read_dataset(f, ds, explicit=True,
                          stop_before_pixels=stop_before_pixels)
            if not ds._elements:
                # nothing parsed: garbage / truncated-below-one-element
                # input, not a headerless dataset
                raise EOFError("not a DICOM stream (no preamble and no "
                               "parseable elements)")
            return ds

        # file meta group: always explicit VR LE
        while True:
            pos = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            group = struct.unpack_from("<H", head)[0]
            f.seek(pos)
            if group != 0x0002:
                break
            el = _read_element(f, explicit=True)
            ds.file_meta.set_raw(el.tag, el.vr, el.raw)

        tsu = ds.file_meta.get("TransferSyntaxUID", EXPLICIT_VR_LE)
        if tsu not in _SUPPORTED and tsu not in _ENCAPSULATED:
            hint = ("lossy/unsupported compression"
                    if tsu.startswith("1.2.840.10008.1.2.4")
                    or tsu.startswith("1.2.840.10008.1.2.5") else
                    "unsupported")
            raise NotImplementedError(
                f"transfer syntax {tsu} ({hint}); this codec reads "
                f"uncompressed LE, RLE Lossless ({RLE_LOSSLESS}) and "
                f"JPEG Lossless ({JPEG_LOSSLESS_SV1}, {JPEG_LOSSLESS_P14})")
        ds.transfer_syntax_uid = tsu
        # encapsulated syntaxes always carry an Explicit VR LE dataset
        _read_dataset(f, ds, explicit=(tsu != IMPLICIT_VR_LE),
                      stop_before_pixels=stop_before_pixels)
        return ds
    finally:
        f.close()


def _read_dataset(f, ds: Dataset, *, explicit: bool,
                  stop_before_pixels: bool):
    while True:
        if stop_before_pixels:
            pos = f.tell()
            head = f.read(4)
            if len(head) < 4:
                return
            group, elem = struct.unpack("<HH", head)
            if (group, elem) >= (0x7FE0, 0x0010):
                return
            f.seek(pos)
        el = _read_element(f, explicit)
        if el is None:
            return
        ds.set_raw(el.tag, el.vr, el.raw)


# ---------------------------------------------------------------- writing
_IMPLEMENTATION_UID = "1.2.826.0.1.3680043.8.498.1"  # generic root
CT_SOP_CLASS = "1.2.840.10008.5.1.4.1.1.2"


def _write_element(out, el: Element, *, explicit: bool):
    group, elem = el.tag
    raw = el.raw
    if len(raw) % 2:
        raw += b"\x00"
    if explicit:
        vr = el.vr if el.vr.isalpha() and len(el.vr) == 2 else "UN"
        if vr in _LONG_VRS:
            out.write(struct.pack("<HH2sHI", group, elem,
                                  vr.encode("ascii"), 0, len(raw)))
        else:
            out.write(struct.pack("<HH2sH", group, elem,
                                  vr.encode("ascii"), len(raw)))
    else:
        out.write(struct.pack("<HHI", group, elem, len(raw)))
    out.write(raw)


def dcmwrite(path: str, ds: Dataset, *, transfer_syntax: str | None = None):
    """Write a Part-10 file with regenerated meta group.

    Default output is plain Explicit VR LE: datasets read from an
    encapsulated (RLE / JPEG Lossless) file are decompressed on write —
    the same normalization the reference pipeline applies when rewriting
    series (masking.py forces ExplicitVRLittleEndian on save).  Pass
    transfer_syntax=RLE_LOSSLESS or JPEG_LOSSLESS_SV1 to write the pixel
    data compressed (encapsulated) instead."""
    out_tsu = transfer_syntax or EXPLICIT_VR_LE
    if out_tsu not in (EXPLICIT_VR_LE,) + _ENCAPSULATED:
        raise NotImplementedError(
            f"cannot write transfer syntax {out_tsu}")
    pixel_tag = (0x7FE0, 0x0010)
    if pixel_tag in ds._elements and ds.transfer_syntax_uid != out_tsu and (
            ds.transfer_syntax_uid in _ENCAPSULATED
            or out_tsu in _ENCAPSULATED):
        from ducosy_tpu_torch.dicom import compressed as _c

        arr = ds.pixel_array  # decodes if the source was encapsulated
        ds = ds.copy()
        if out_tsu == RLE_LOSSLESS:
            frag = _c.rle_encode_frame(arr)
            ds.set_raw(pixel_tag, "OB", _c.encapsulate([frag]))
        elif out_tsu in (JPEG_LOSSLESS_SV1, JPEG_LOSSLESS_P14):
            # SV1 codestreams are legal under both syntaxes (predictor 1
            # is one of the .4.57 family's seven)
            bits = int(ds.get("BitsAllocated", 16))
            frag = _c.jpeg_sv1_encode(arr, precision=bits)
            ds.set_raw(pixel_tag, "OB", _c.encapsulate([frag]))
        else:
            ds.set_raw(pixel_tag, "OW", arr.tobytes())
        ds.transfer_syntax_uid = out_tsu
    meta = ds.file_meta.copy()
    meta.set((0x0002, 0x0001), "OB", b"\x00\x01")
    if (0x0002, 0x0002) not in dict.fromkeys(meta._elements):
        sop_class = ds.get("SOPClassUID", CT_SOP_CLASS)
        meta.set((0x0002, 0x0002), "UI", sop_class)
    sop_inst = ds.get("SOPInstanceUID")
    if sop_inst:
        meta.set((0x0002, 0x0003), "UI", sop_inst)
    meta.set((0x0002, 0x0010), "UI", out_tsu)
    meta.set((0x0002, 0x0012), "UI", _IMPLEMENTATION_UID)
    meta.set((0x0002, 0x0013), "SH", "DUCOSY_TPU")

    body = io.BytesIO()
    for tag in sorted(meta._elements):
        if tag == (0x0002, 0x0000):
            continue
        _write_element(body, meta._elements[tag], explicit=True)
    meta_bytes = body.getvalue()

    out = io.BytesIO()
    out.write(b"\x00" * 128)
    out.write(b"DICM")
    _write_element(out, Element((0x0002, 0x0000), "UL",
                                struct.pack("<I", len(meta_bytes))),
                   explicit=True)
    out.write(meta_bytes)
    for tag in sorted(ds._elements):
        if tag == pixel_tag and out_tsu in _ENCAPSULATED:
            # encapsulated PixelData: OB with undefined length; the raw
            # value already carries the item framing + sequence delimiter
            el = ds._elements[tag]
            out.write(struct.pack("<HH", *tag))
            out.write(b"OB\x00\x00")
            out.write(struct.pack("<I", _UNDEFINED))
            out.write(el.raw)
            continue
        _write_element(out, ds._elements[tag], explicit=True)

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(out.getvalue())
    os.replace(tmp, path)


def new_ct_dataset(rows: int, cols: int, *, slope: float = 1.0,
                   intercept: float = -1024.0, signed: bool = False,
                   instance_number: int = 1,
                   series_description: str = "CT") -> Dataset:
    """Create a minimal valid CT dataset (testing + synthetic phantoms)."""
    ds = Dataset()
    ds.set(KEYWORD_TO_TAG["SOPClassUID"], "UI", CT_SOP_CLASS)
    ds.set(KEYWORD_TO_TAG["SOPInstanceUID"], "UI",
           f"{_IMPLEMENTATION_UID}.{instance_number}")
    ds.Modality = "CT"
    ds.SeriesDescription = series_description
    ds.InstanceNumber = instance_number
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.Rows = rows
    ds.Columns = cols
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 1 if signed else 0
    ds.RescaleSlope = slope
    ds.RescaleIntercept = intercept
    ds.PixelSpacing = [1.0, 1.0]
    ds.SliceThickness = 1.0
    return ds
