"""Compressed DICOM transfer syntaxes: RLE Lossless and JPEG Lossless SV1.

The reference reads compressed archives transparently because pydicom's
``pixel_array`` dispatches to the python-rle / pylibjpeg / gdcm wheels it
installs (the reference's requirements.txt, modules/preprocess.py:68-90,
modules/dataset.py:109-120).  This module gives our self-contained codec
the same capability for the two syntaxes that dominate lossless CT
archives, with no third-party wheels:

  - RLE Lossless (1.2.840.10008.1.2.5) — PS3.5 Annex G: a 64-byte segment
    offset header, then one PackBits-compressed segment per byte plane
    (MSB plane first for 16-bit data).
  - JPEG Lossless, Non-Hierarchical, First-Order Prediction, SV1
    (1.2.840.10008.1.2.4.70) — ITU-T T.81 process 14 selection value 1:
    SOF3 frame, Huffman-coded prediction differences, left-neighbour
    predictor (Px = Ra; Rb on row starts), optional restart markers.
  - JPEG Lossless, Non-Hierarchical, Process 14 (1.2.840.10008.1.2.4.57)
    — the same codestream family with any T.81 Table H.1 predictor
    (selection values 1-7); pylibjpeg decodes this syntax for the
    reference, so we do too.

Both decoders are pure numpy/Python (a native fast path can layer on
later); encoders are provided for round-trip tests and for writing
RLE-compressed output.  Encapsulated-PixelData item framing (PS3.5 A.4)
is parsed/produced here as well.

Lossy families (JPEG baseline, J2K) remain rejected with a clear message
in codec.dcmread — matching the project's lossless-only scope.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"

_ITEM = (0xFFFE, 0xE000)
_SEQ_DELIM = (0xFFFE, 0xE0DD)


# --------------------------------------------------------------------------
# Encapsulated PixelData framing (PS3.5 A.4)
# --------------------------------------------------------------------------

def parse_encapsulated(raw: bytes) -> Tuple[List[int], List[bytes]]:
    """Split an encapsulated PixelData value into (offset_table, fragments).

    `raw` is the item stream as retained by the dataset reader: zero or
    more (FFFE,E000) items, optionally followed by the (FFFE,E0DD)
    delimiter.  The first item is the Basic Offset Table (possibly empty).
    """
    off = 0
    items: List[bytes] = []
    n = len(raw)
    while off + 8 <= n:
        group, elem, length = struct.unpack_from("<HHI", raw, off)
        off += 8
        if (group, elem) == _SEQ_DELIM:
            break
        if (group, elem) != _ITEM:
            raise ValueError(
                f"encapsulated pixel data: unexpected tag "
                f"({group:04X},{elem:04X})")
        if length == 0xFFFFFFFF or off + length > n:
            raise ValueError("encapsulated pixel data: bad item length")
        items.append(raw[off:off + length])
        off += length
    if not items:
        raise ValueError("encapsulated pixel data: no items")
    bot, fragments = items[0], items[1:]
    if len(bot) % 4:
        raise ValueError("encapsulated pixel data: offset table not u32s")
    offsets = list(struct.unpack(f"<{len(bot) // 4}I", bot))
    if not fragments:
        raise ValueError("encapsulated pixel data: no pixel fragments")
    return offsets, fragments


def encapsulate(fragments: List[bytes], *, offsets: bool = True) -> bytes:
    """Build an encapsulated PixelData value (items + sequence delimiter)."""
    out = bytearray()
    if offsets:
        bot = bytearray()
        pos = 0
        for frag in fragments:
            bot += struct.pack("<I", pos)
            pos += 8 + len(frag) + (len(frag) % 2)
        out += struct.pack("<HHI", *_ITEM, len(bot)) + bytes(bot)
    else:
        out += struct.pack("<HHI", *_ITEM, 0)
    for frag in fragments:
        if len(frag) % 2:
            frag = frag + b"\x00"
        out += struct.pack("<HHI", *_ITEM, len(frag)) + frag
    out += struct.pack("<HHI", *_SEQ_DELIM, 0)
    return bytes(out)


# --------------------------------------------------------------------------
# RLE Lossless (PS3.5 Annex G)
# --------------------------------------------------------------------------

def _packbits_decode(data: bytes, start: int, end: int,
                     expected: int) -> bytes:
    """Decode one PackBits segment (data[start:end]) to `expected` bytes."""
    out = bytearray()
    i = start
    want = expected
    while len(out) < want:
        if i >= end:
            raise ValueError("RLE segment truncated")
        n = data[i]
        i += 1
        if n < 128:  # literal run of n+1 bytes
            j = i + n + 1
            if j > end:
                raise ValueError("RLE literal run past segment end")
            out += data[i:j]
            i = j
        elif n > 128:  # replicate next byte 257-n times
            if i >= end:
                raise ValueError("RLE replicate run truncated")
            out += data[i:i + 1] * (257 - n)
            i += 1
        # n == 128: no-op
    if len(out) > want:
        # runs may overshoot the plane by padding; DICOM requires exact
        # plane sizes, so anything beyond a trailing pad byte is corrupt
        if len(out) - want > 1:
            raise ValueError("RLE segment decodes past plane size")
        del out[want:]
    return bytes(out)


def _packbits_encode(plane: bytes) -> bytes:
    """PackBits-encode one byte plane (max literal/replicate run 128)."""
    out = bytearray()
    i, n = 0, len(plane)
    while i < n:
        # find replicate run
        j = i
        while j + 1 < n and plane[j + 1] == plane[i] and j - i < 127:
            j += 1
        run = j - i + 1
        if run >= 2:
            out.append(257 - run)
            out.append(plane[i])
            i = j + 1
            continue
        # literal run plane[i:j]: until the next >=3 replicate or 128 bytes
        j = i
        while j < n and j - i < 128:
            if j + 2 < n and plane[j] == plane[j + 1] == plane[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += plane[i:j]
        i = j
    return bytes(out)


def rle_decode_frame(data: bytes, rows: int, cols: int,
                     bits_allocated: int) -> np.ndarray:
    """Decode one RLE Lossless frame to a (rows, cols) uint8/uint16 array.

    The frame starts with a 64-byte header of 16 little-endian uint32s:
    segment count then up to 15 segment offsets (from frame start).  16-bit
    data is split into two byte planes, most-significant first.
    """
    if len(data) < 64:
        raise ValueError("RLE frame shorter than its 64-byte header")
    header = struct.unpack("<16I", data[:64])
    nseg = header[0]
    bytes_per_sample = bits_allocated // 8
    if nseg != bytes_per_sample:
        raise ValueError(
            f"RLE header has {nseg} segments; expected {bytes_per_sample} "
            f"for BitsAllocated={bits_allocated} single-sample data")
    offsets = [header[1 + k] for k in range(nseg)]
    if offsets[0] != 64 or any(o <= 0 or o >= len(data) for o in offsets):
        raise ValueError("RLE header offsets out of range")
    ends = offsets[1:] + [len(data)]
    plane_size = rows * cols
    planes = [
        np.frombuffer(
            _packbits_decode(data, off, end, plane_size), np.uint8)
        for off, end in zip(offsets, ends)]
    if bytes_per_sample == 1:
        return planes[0].reshape(rows, cols).copy()
    # MSB plane first (composite pixel code, big-endian byte order)
    out = (planes[0].astype(np.uint16) << 8) | planes[1]
    return out.reshape(rows, cols)


def rle_encode_frame(arr: np.ndarray) -> bytes:
    """Encode a 2-D uint8/uint16 (or int8/int16, via view) frame as RLE."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype in (np.int16, np.uint16):
        u = arr.view(np.uint16) if arr.dtype == np.int16 else arr
        planes = [(u >> 8).astype(np.uint8).tobytes(),
                  (u & 0xFF).astype(np.uint8).tobytes()]
    elif arr.dtype in (np.int8, np.uint8):
        planes = [arr.view(np.uint8).tobytes()]
    else:
        raise ValueError(f"unsupported dtype for RLE: {arr.dtype}")
    segs = []
    for p in planes:
        s = _packbits_encode(p)
        if len(s) % 2:
            s += b"\x00"  # segments are padded to even length
        segs.append(s)
    header = [len(segs)]
    pos = 64
    for s in segs:
        header.append(pos)
        pos += len(s)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segs)


# --------------------------------------------------------------------------
# JPEG Lossless, first-order prediction, selection value 1 (T.81 process 14)
# --------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over entropy-coded JPEG data with 0xFF00 byte
    stuffing; surfaces markers (RSTn / EOI) between samples."""

    __slots__ = ("data", "pos", "acc", "nbits", "marker", "pad_bits")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None  # set when a non-stuffing marker is hit
        self.pad_bits = 0  # synthetic 1-bits appended at a marker/EOF

    def _fill(self):
        data = self.data
        while self.nbits <= 24:
            if self.marker is not None or self.pos >= len(data):
                # buffer synthetic 1-bits at a marker / past the end; a
                # conforming stream never actually CONSUMES them (read()
                # raises when one is), since the encoder-written sample
                # bits end before its byte-boundary padding
                self.acc = (self.acc << 8) | 0xFF
                self.nbits += 8
                self.pad_bits += 8
                continue
            b = data[self.pos]
            if b == 0xFF:
                if self.pos + 1 >= len(data):
                    raise ValueError("JPEG stream ends inside a marker")
                m = data[self.pos + 1]
                if m == 0x00:  # stuffed 0xFF data byte
                    self.pos += 2
                    self.acc = (self.acc << 8) | 0xFF
                    self.nbits += 8
                    continue
                # a real marker: stop consuming; pos stays at the 0xFF
                self.marker = 0xFF00 | m
                continue
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        if self.nbits < self.pad_bits:
            # a read dipped into the synthetic padding: the entropy data
            # ended (marker / EOF) before all samples were coded
            raise ValueError("JPEG entropy data truncated mid-scan")
        return v

    def seek_marker(self) -> int:
        """Drop buffered (pad) bits and scan forward to the next marker;
        returns it without consuming its two bytes."""
        self.acc = 0
        self.nbits = 0
        self.pad_bits = 0
        self.marker = None
        data = self.data
        p = self.pos
        while p + 1 < len(data):
            if data[p] == 0xFF and data[p + 1] != 0x00:
                self.marker = 0xFF00 | data[p + 1]
                self.pos = p
                return self.marker
            p += 1
        raise ValueError("JPEG: expected a marker")


def _build_huffman(counts: List[int], symbols: List[int]):
    """Canonical Huffman (T.81 C.2): returns {(length, code): symbol}."""
    if len(counts) != 16 or len(symbols) != sum(counts):
        raise ValueError("JPEG DHT segment truncated")
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _huff_decode(br: _BitReader, table) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.read(1)
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise ValueError("invalid JPEG Huffman code")


def _extend(v: int, s: int) -> int:
    """T.81 F.2.2.1 EXTEND: map s magnitude bits to a signed difference."""
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def jpeg_sv1_decode(data: bytes, *,
                    native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a single-component JPEG Lossless (T.81 process 14) stream.

    Returns (samples as uint16 (rows, cols), precision).  Supports SOF3
    with one component, any predictor selection value 1-7 (Table H.1),
    point transform Al, and DRI/RSTn restart markers.  Raises ValueError
    on malformed streams and on JPEG features outside that profile
    (multi-component scans, hierarchical selection value 0).

    The native C++ decoder (native/dicom_codec.cc, ~55x this Python
    implementation at 512^2) is tried first; it covers all seven
    predictors and declines anything outside the profile, in which case
    this pure-Python path — the reference semantics — decodes it
    (`native=False` forces it, for parity tests).
    """
    if native:
        from ducosy_tpu_torch.dicom.native import jpeg_sv1_decode_native

        got = jpeg_sv1_decode_native(data)
        if got is not None:
            return got
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    huff_tables = {}
    restart_interval = 0
    scan = None  # (table_id, selection, al, entropy_start)
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"expected marker at offset {pos}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # optional fill bytes before a marker (T.81 B.1.1.2)
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI before any scan
            break
        if pos + 2 > len(data):
            raise ValueError("JPEG stream truncated at a marker segment")
        seg_len = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + seg_len]
        if len(seg) != seg_len - 2:
            raise ValueError("JPEG marker segment truncated")
        if marker == 0xC3:  # SOF3: lossless, Huffman
            precision = seg[0]
            rows, cols = struct.unpack_from(">HH", seg, 1)
            ncomp = seg[5]
            if ncomp != 1:
                raise ValueError(
                    f"JPEG lossless: only single-component CT streams are "
                    f"supported (got {ncomp} components)")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7,
                        0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(
                f"JPEG SOF{marker - 0xC0}: not lossless process 14 "
                "(only SOF3 is supported)")
        elif marker == 0xC4:  # DHT (may hold several tables)
            o = 0
            while o < len(seg):
                tc_th = seg[o]
                counts = list(seg[o + 1:o + 17])
                nsym = sum(counts)
                symbols = list(seg[o + 17:o + 17 + nsym])
                if (tc_th >> 4) == 0:  # DC-class: the lossless tables
                    huff_tables[tc_th & 0x0F] = _build_huffman(counts,
                                                               symbols)
                o += 17 + nsym
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack_from(">H", seg)[0]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            if ns != 1:
                raise ValueError("JPEG lossless: multi-component scan")
            table_id = seg[2] >> 4
            selection = seg[1 + 2 * ns]  # Ss = predictor selection value
            al = seg[3 + 2 * ns] & 0x0F  # point transform
            if not 1 <= selection <= 7:
                raise ValueError(
                    f"JPEG lossless selection value {selection}; only the "
                    "T.81 Table H.1 predictors (1-7) are supported")
            scan = (table_id, selection, al, pos + seg_len)
            break
        # APPn/COM/other: skip
        pos += seg_len
    if precision is None or scan is None:
        raise ValueError("JPEG stream missing SOF3/SOS")
    table_id, sel, al, entropy_start = scan
    table = huff_tables.get(table_id)
    if table is None:
        raise ValueError(f"JPEG scan references missing Huffman table "
                         f"{table_id}")

    br = _BitReader(data, entropy_start)
    out = np.empty(rows * cols, np.uint16)
    default = 1 << (precision - 1 - al)
    mask = 0xFFFF
    samples_until_restart = restart_interval if restart_interval else -1
    restart_reset = True  # start-of-scan behaves like a restart
    first_line_row = 0  # first line after a restart uses Ra (T.81 H.2.2)
    idx = 0
    read = br.read
    for r in range(rows):
        for c in range(cols):
            if samples_until_restart == 0:
                # byte-align, expect RSTn, reset prediction
                m = br.seek_marker()
                br.marker = None
                if not (0xFFD0 <= m <= 0xFFD7):
                    raise ValueError("JPEG: expected restart marker")
                br.pos += 2
                samples_until_restart = restart_interval
                restart_reset = True
            s = _huff_decode(br, table)
            if s == 16:  # 16 means diff = 32768, no magnitude bits
                diff = 32768
            elif s:
                diff = _extend(read(s), s)
            else:
                diff = 0
            if restart_reset:
                pred = default
                restart_reset = False
                first_line_row = r
            elif c == 0:
                pred = int(out[idx - cols])  # Rb: first sample of the row
            elif r == first_line_row or sel == 1:
                pred = int(out[idx - 1])  # Ra (predictor 1; also the
                # mandated predictor for the interval's first line)
            else:
                ra = int(out[idx - 1])
                rb = int(out[idx - cols])
                rc = int(out[idx - cols - 1])
                if sel == 2:
                    pred = rb
                elif sel == 3:
                    pred = rc
                elif sel == 4:
                    pred = ra + rb - rc
                elif sel == 5:
                    pred = ra + ((rb - rc) >> 1)
                elif sel == 6:
                    pred = rb + ((ra - rc) >> 1)
                else:  # sel == 7
                    pred = (ra + rb) >> 1
            out[idx] = (pred + diff) & mask
            idx += 1
            if samples_until_restart > 0:
                samples_until_restart -= 1
    if br.marker is not None and br.marker not in (0xFFD9,) and \
            not (0xFFD0 <= br.marker <= 0xFFD7):
        raise ValueError(f"JPEG: unexpected marker {br.marker:#x} in scan")
    if al:
        out <<= al
    return out.reshape(rows, cols), precision


# encoder Huffman table: all 17 difference categories, short codes for the
# small diffs that dominate CT content.  Kraft sum is exactly 1 (asserted
# in tests); max code length 15 so the reserved all-ones 16-bit code never
# appears.
_ENC_COUNTS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 0]
_ENC_SYMBOLS = list(range(17))


def _encoder_codes():
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(_ENC_COUNTS[length - 1]):
            codes[_ENC_SYMBOLS[k]] = (length, code)
            code += 1
            k += 1
        code <<= 1
    return codes


def jpeg_sv1_encode(arr: np.ndarray, precision: int = 16,
                    predictor: int = 1) -> bytes:
    """Encode a 2-D array of unsigned samples (< 2**precision) as JPEG
    Lossless (T.81 process 14).  predictor selects the Table H.1 scheme
    (1 = SV1, the DICOM .4.70 profile; 2-7 are legal under the general
    .4.57 syntax).  Used for round-trip tests and compressed fixtures."""
    if not 1 <= predictor <= 7:
        raise ValueError(f"JPEG lossless predictor {predictor} out of 1-7")
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "i":
        arr = arr.view(np.uint8 if arr.dtype.itemsize == 1 else np.uint16)
    rows, cols = arr.shape
    a = arr.astype(np.int32)
    # T.81 H.1.2.2/H.2.2 prediction: the very first sample uses the
    # precision default, the rest of the first line uses Ra, row starts
    # use Rb, and interior samples use the selected predictor
    pred = np.empty_like(a)
    pred[0, 0] = 1 << (precision - 1)
    pred[0, 1:] = a[0, :-1]
    if rows > 1:
        pred[1:, 0] = a[:-1, 0]
        ra, rb, rc = a[1:, :-1], a[:-1, 1:], a[:-1, :-1]
        if predictor == 1:
            interior = ra
        elif predictor == 2:
            interior = rb
        elif predictor == 3:
            interior = rc
        elif predictor == 4:
            interior = ra + rb - rc
        elif predictor == 5:
            interior = ra + ((rb - rc) >> 1)
        elif predictor == 6:
            interior = rb + ((ra - rc) >> 1)
        else:  # predictor == 7
            interior = (ra + rb) >> 1
        pred[1:, 1:] = interior
    flat = a.ravel()
    diffs = ((flat - pred.ravel()) & 0xFFFF).astype(np.uint16)
    # map to signed 16-bit difference domain (mod 2^16 arithmetic)
    sdiff = diffs.astype(np.int32)
    sdiff[sdiff >= 32768] -= 65536

    codes = _encoder_codes()
    bits = bytearray()
    acc = 0
    nacc = 0

    def put(val: int, n: int):
        nonlocal acc, nacc
        acc = (acc << n) | (val & ((1 << n) - 1))
        nacc += n
        while nacc >= 8:
            nacc -= 8
            b = (acc >> nacc) & 0xFF
            bits.append(b)
            if b == 0xFF:
                bits.append(0x00)  # byte stuffing
        acc &= (1 << nacc) - 1

    for d in sdiff:
        d = int(d)
        if d == -32768:
            ln, code = codes[16]
            put(code, ln)
            continue
        mag = abs(d)
        s = mag.bit_length()
        ln, code = codes[s]
        put(code, ln)
        if s:
            v = d if d >= 0 else d + (1 << s) - 1
            put(v, s)
    if nacc:
        put(0x7F, 8 - nacc)  # pad with 1s
    entropy = bytes(bits)

    dht_payload = bytes([0x00] + _ENC_COUNTS) + bytes(_ENC_SYMBOLS)
    out = bytearray(b"\xFF\xD8")  # SOI
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xFF\xC3" + struct.pack(">H", 2 + len(sof)) + sof
    out += b"\xFF\xC4" + struct.pack(">H", 2 + len(dht_payload)) + dht_payload
    # 1 component, table 0, Ss = predictor selection value, Al = 0
    sos = bytes([1, 1, 0x00, predictor, 0, 0x00])
    out += b"\xFF\xDA" + struct.pack(">H", 2 + len(sos)) + sos
    out += entropy
    out += b"\xFF\xD9"  # EOI
    return bytes(out)
