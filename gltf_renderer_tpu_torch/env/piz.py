"""PIZ codec for OpenEXR (wavelet + Huffman).

Copy of gltf_renderer_tpu/env/piz.py: the PIZ scanline-block codec per the
OpenEXR specification (bitmap/LUT + canonical Huffman with zero-run codes +
2D Haar-like wavelet) in Python/numpy, encoder and decoder. `piz_uncompress`
decodes through the C++ decoder `native/exr_piz.cpp`, compiled with g++ into
build/torch_ext/ at first use; a failed build raises. The Python decoder is
bit-serial (minutes on a 2k map) and is the plain version the tests hold
the native one to (`allow_native=False`).
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from gltf_renderer_tpu_torch.ops.bvh import host_library

_NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
                           "exr_piz.cpp")
NATIVE_DECODES = 0  # blocks decoded by the native decoder (read by chip_smoke)

HUF_ENCBITS = 16
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECBITS = 14
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

NBITS = 16
# OpenEXR ImfWav.cpp: A_OFFSET = M_OFFSET = 1 << (NBITS - 1) = 1 << 15.
# (Was 1 << 14 through round 3 — wrong, but unobservable then because the
# maxValue bug routed every real block to the 14-bit wavelet; fixed round 4
# together with a single-block >=2^14-distinct-values regression test.)
A_OFFSET = 1 << (NBITS - 1)
M_OFFSET = 1 << (NBITS - 1)
MOD_MASK = (1 << NBITS) - 1


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0       # bit buffer
        self.lc = 0      # bits in buffer

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(br: _BitReader, im: int, iM: int):
    """hufUnpackEncTable: 6-bit code lengths with zero-run codes."""
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        hcode[i] = l
        if l == 63:  # LONG_ZEROCODE_RUN
            zerun = br.get_bits(8) + 6  # SHORTEST_LONG_RUN = 59 + 2 - 63 + 8...
            for _ in range(zerun):
                hcode[i] = 0
                i += 1
            i -= 1
        elif l >= 59:  # SHORT_ZEROCODE_RUN
            zerun = l - 59 + 2
            for _ in range(zerun):
                hcode[i] = 0
                i += 1
            i -= 1
        i += 1
    _build_canonical_codes(hcode)
    return hcode


def _build_canonical_codes(hcode):
    """hufCanonicalCodeTable: lengths -> canonical codes (in place:
    hcode[i] = code << 6 | length)."""
    n = np.zeros(59, np.int64)
    lens = hcode.copy()
    for l in lens:
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    for i in range(HUF_ENCSIZE):
        l = int(lens[i])
        if l > 0:
            hcode[i] = (l | (int(n[l]) << 6))
            n[l] += 1


def _huf_length(code):
    return code & 63


def _huf_code(code):
    return code >> 6


def _build_dec_table(hcode, im, iM):
    """hufBuildDecTable: short-code lookup + long-code lists."""
    fast_len = np.zeros(HUF_DECSIZE, np.int32)
    fast_lit = np.zeros(HUF_DECSIZE, np.int64)
    longs = {}
    for c in range(im, iM + 1):
        l = _huf_length(int(hcode[c]))
        code = _huf_code(int(hcode[c]))
        if l == 0:
            continue
        if l > HUF_DECBITS:
            pl = code >> (l - HUF_DECBITS)
            longs.setdefault(pl, []).append(c)
        else:
            base = code << (HUF_DECBITS - l)
            count = 1 << (HUF_DECBITS - l)
            fast_len[base : base + count] = l
            fast_lit[base : base + count] = c
    return fast_len, fast_lit, longs


def _huf_decode(data: bytes, nbits: int, hcode, fast_len, fast_lit, longs, rlc, n_out):
    """hufDecode: bitstream -> n_out u16 symbols."""
    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    pos = 0
    n_bytes = (nbits + 7) // 8

    def get_char():
        nonlocal c, lc, pos
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8

    while pos < n_bytes:
        get_char()
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = int(fast_len[idx])
            if l > 0:
                lc -= l
                sym = int(fast_lit[idx])
                # run-length code?
                if sym == rlc:
                    if lc < 8:
                        get_char()
                    run = (c >> (lc - 8)) & 0xFF
                    lc -= 8
                    out[oi : oi + run] = out[oi - 1]
                    oi += run
                else:
                    out[oi] = sym
                    oi += 1
            else:
                # long code: search the candidate list
                found = False
                for sym in longs.get(idx, ()):
                    code_l = _huf_length(int(hcode[sym]))
                    code_c = _huf_code(int(hcode[sym]))
                    while lc < code_l and pos < n_bytes:
                        get_char()
                    if lc >= code_l and code_c == ((c >> (lc - code_l)) & ((1 << code_l) - 1)):
                        lc -= code_l
                        if sym == rlc:
                            if lc < 8:
                                get_char()
                            run = (c >> (lc - 8)) & 0xFF
                            lc -= 8
                            out[oi : oi + run] = out[oi - 1]
                            oi += run
                        else:
                            out[oi] = sym
                            oi += 1
                        found = True
                        break
                if not found:
                    raise ValueError("PIZ: invalid Huffman code")
        # n_bytes reached; flush handled below
    # Final bits (< HUF_DECBITS): continue decoding from the tail buffer.
    i = 8 - nbits % 8
    if i == 8:
        i = 0
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = int(fast_len[idx])
        if l > 0 and l <= lc:
            lc -= l
            sym = int(fast_lit[idx])
            if sym == rlc:
                if lc < 8:
                    raise ValueError("PIZ: truncated run")
                run = (c >> (lc - 8)) & 0xFF
                lc -= 8
                out[oi : oi + run] = out[oi - 1]
                oi += run
            else:
                out[oi] = sym
                oi += 1
        else:
            raise ValueError("PIZ: invalid code in tail")
        if oi >= n_out:
            break
    if oi != n_out:
        raise ValueError(f"PIZ: decoded {oi} of {n_out} symbols")
    return out


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, table_len, nbits, _ = struct.unpack_from("<iiiii", data, 0)
    br = _BitReader(data[20:])
    hcode = _unpack_enc_table(br, im, iM)
    fast_len, fast_lit, longs = _build_dec_table(hcode, im, iM)
    bitstream = data[20 + br.pos :]
    return _huf_decode(bitstream, nbits, hcode, fast_len, fast_lit, longs, iM, n_out)


def _wdec14(l, h):
    ls = int(l)
    hs = int(h)
    # signed 16-bit interpretation
    if ls >= 32768:
        ls -= 65536
    if hs >= 32768:
        hs -= 65536
    ai = ls + (hs & 1) + (hs >> 1)
    return np.uint16(ai & MOD_MASK), np.uint16((ai - hs) & MOD_MASK)


def _wdec16(l, h):
    m = int(l)
    d = int(h)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return np.uint16(aa), np.uint16(bb)


def wav2_decode(a: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """Inverse 2D wavelet (ImfWav.cpp wav2Decode semantics). In place.

    a is a flat uint16 array; element (y, x) lives at a[y*oy + x*ox].
    """
    w14 = mx < (1 << 14)
    n = ny if nx > ny else nx          # MIN(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    dec = _wdec14 if w14 else _wdec16
    while p >= 1:
        row_step = p * oy
        col_step = p * ox
        y = 0
        while y <= ny - p2:
            x = 0
            base_y = y * oy
            while x <= nx - p2:
                i00 = base_y + x * ox
                i01 = i00 + col_step      # right
                i10 = i00 + row_step      # down
                i11 = i10 + col_step
                # Vertical pairs first, then horizontal (decode order).
                v00, v10 = dec(a[i00], a[i10])
                v01, v11 = dec(a[i01], a[i11])
                a[i00], a[i01] = dec(v00, v01)
                a[i10], a[i11] = dec(v10, v11)
                x += p2
            if nx & p:
                i00 = base_y + (nx - p) * ox
                i10 = i00 + row_step
                a[i00], a[i10] = dec(a[i00], a[i10])
            y += p2
        if ny & p:
            x = 0
            base_y = (ny - p) * oy
            while x <= nx - p2:
                i00 = base_y + x * ox
                i01 = i00 + col_step
                a[i00], a[i01] = dec(a[i00], a[i01])
                x += p2
        p2 = p
        p >>= 1
    return a


def reverse_lut_from_bitmap(bitmap: np.ndarray):
    """lut[compact] = original value. Value 0 is ALWAYS included
    (ImfPizCompressor reverseLutFromBitmap: i == 0 || bitmap bit set).

    Returns (lut, k) with k = number of present values; OpenEXR's
    maxValue — the wdec14/wdec16 selector passed to wav2Decode — is k-1
    (the largest COMPACTED index), NOT any per-plane data maximum."""
    bits = np.unpackbits(bitmap, bitorder="little")
    bits = bits[: 1 << 16].copy()
    bits[0] = 1
    present = np.nonzero(bits)[0]
    lut = np.zeros(1 << 16, np.uint16)
    lut[: len(present)] = present.astype(np.uint16)
    return lut, len(present)


_NATIVE = None


def native_piz() -> ctypes.CDLL:
    """The C++ decoder's library, built at first use."""
    global _NATIVE
    if _NATIVE is None:
        lib = host_library(os.path.abspath(_NATIVE_SRC))
        lib.piz_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint16)]
        lib.piz_decode.restype = ctypes.c_int
        _NATIVE = lib
    return _NATIVE


def piz_uncompress(raw: bytes, channels, width: int, n_lines: int,
                   allow_native: bool = True) -> bytes:
    """Decompress one PIZ chunk -> raw scanline bytes (channels alphabetical,
    per scanline, like uncompressed EXR layout).

    channels: list of (name, pixel_type) sorted alphabetically;
    pixel_type: 0=uint32, 1=half, 2=float. PIZ stores everything as u16
    planes (2 u16s for float/uint).
    """
    if allow_native:
        global NATIVE_DECODES
        sizes_n = {0: 2, 1: 1, 2: 2}
        n16s = np.asarray([sizes_n[t] for _, t in channels], np.int32)
        out = np.empty(int(n16s.sum()) * width * n_lines, np.uint16)
        rc = native_piz().piz_decode(
            raw, len(raw), width, n_lines, n16s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(channels), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if rc != 0:
            raise ValueError(f"corrupt PIZ block (native decoder error {rc})")
        NATIVE_DECODES += 1
        return out.tobytes()
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", raw, pos)
    pos += 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(raw, np.uint8, n, pos)
        pos += n
    lut, k_present = reverse_lut_from_bitmap(bitmap)
    max_value = k_present - 1  # wav2Decode's wdec14/wdec16 selector

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4

    # Total u16 count over all channel planes.
    sizes = {0: 2, 1: 1, 2: 2}  # u16s per pixel component
    total = 0
    chan_info = []
    for name, ptype in channels:
        n16 = sizes[ptype]
        count = width * n_lines * n16
        chan_info.append((name, ptype, n16, count))
        total += count

    data = huf_uncompress(raw[pos : pos + length], total)

    # Wavelet-decode each channel plane, then apply LUT. 32-bit channels
    # (float/uint, size 2) are TWO interleaved u16 fields — OpenEXR runs
    # wav2Decode once per 16-bit slice j with ox = size, oy = nx*size
    # (ImfPizCompressor::uncompress), NOT one wavelet over 2x the columns.
    offset = 0
    planes = {}
    for name, ptype, n16, count in chan_info:
        plane = data[offset : offset + count].copy()
        offset += count
        ny = n_lines
        for j in range(n16):
            wav2_decode(plane[j:], width, n16, ny, width * n16, max_value)
        plane = lut[plane]
        planes[name] = (plane.reshape(ny, width * n16), ptype, n16)

    # Interleave to EXR scanline layout: per line, channels alphabetical.
    out = bytearray()
    for y in range(n_lines):
        for name, ptype, n16, count in chan_info:
            plane, _, _ = planes[name]
            out += plane[y].tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ encoder (tests/tools only — decodable by piz_uncompress and by any
# OpenEXR reader; run codes, zero-run table packing and both wavelet
# transforms mirror ImfHuf.cpp / ImfWav.cpp)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def put_bits(self, val: int, n: int):
        self.c = (self.c << n) | (val & ((1 << n) - 1))
        self.lc += n
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    @property
    def bit_count(self) -> int:
        return len(self.out) * 8 + self.lc

    def pad_to_byte(self):
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0

    def bytes(self) -> bytes:
        self.pad_to_byte()
        return bytes(self.out)


def _wenc14(a, b):
    a_s = int(a) - 65536 if a >= 32768 else int(a)
    b_s = int(b) - 65536 if b >= 32768 else int(b)
    ms = (a_s + b_s) >> 1
    ds = a_s - b_s
    return np.uint16(ms & MOD_MASK), np.uint16(ds & MOD_MASK)


def _wenc16(a, b):
    ao = (int(a) + A_OFFSET) & MOD_MASK
    m = (ao + int(b)) >> 1
    d = ao - int(b)
    if d < 0:
        m = (m + M_OFFSET) & MOD_MASK
    return np.uint16(m & MOD_MASK), np.uint16(d & MOD_MASK)


def wav2_encode(a: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """Forward 2D wavelet (ImfWav.cpp wav2Encode). Exact inverse of
    wav2_decode: horizontal pairs first, then vertical."""
    w14 = mx < (1 << 14)
    enc = _wenc14 if w14 else _wenc16
    n = ny if nx > ny else nx
    p = 1
    p2 = 2
    while p2 <= n:
        row_step = p * oy
        col_step = p * ox
        y = 0
        while y <= ny - p2:
            x = 0
            base_y = y * oy
            while x <= nx - p2:
                i00 = base_y + x * ox
                i01 = i00 + col_step
                i10 = i00 + row_step
                i11 = i10 + col_step
                v00, v01 = enc(a[i00], a[i01])
                v10, v11 = enc(a[i10], a[i11])
                a[i00], a[i10] = enc(v00, v10)
                a[i01], a[i11] = enc(v01, v11)
                x += p2
            if nx & p:
                i00 = base_y + (nx - p) * ox
                i10 = i00 + row_step
                a[i00], a[i10] = enc(a[i00], a[i10])
            y += p2
        if ny & p:
            x = 0
            base_y = (ny - p) * oy
            while x <= nx - p2:
                i00 = base_y + x * ox
                i01 = i00 + col_step
                a[i00], a[i01] = enc(a[i00], a[i01])
                x += p2
        p = p2
        p2 <<= 1
    return a


def _build_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths from symbol frequencies (heap merge)."""
    import heapq
    import itertools

    lens = np.zeros(len(freq), np.int64)
    idx = np.nonzero(freq)[0]
    if len(idx) == 0:
        return lens
    if len(idx) == 1:
        lens[idx[0]] = 1
        return lens
    tb = itertools.count()  # tiebreak: heap never compares tree nodes
    heap = [(int(freq[i]), next(tb), (int(i),)) for i in idx]
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        lens[list(sa + sb)] += 1
        heapq.heappush(heap, (fa + fb, next(tb), sa + sb))
    return lens


def _pack_enc_table(bw: _BitWriter, lengths: np.ndarray, im: int, iM: int):
    """hufPackEncTable: 6-bit lengths with SHORT(59-62)/LONG(63) zero runs."""
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            run = 1
            while i + run <= iM and run < 261 and lengths[i + run] == 0:
                run += 1
            if run >= 6:
                bw.put_bits(63, 6)
                bw.put_bits(run - 6, 8)
                i += run
                continue
            if run >= 2:
                bw.put_bits(59 + run - 2, 6)
                i += run
                continue
        bw.put_bits(l, 6)
        i += 1


def huf_compress(data: np.ndarray) -> bytes:
    """ImfHuf.cpp hufCompress: frequency count, canonical table (with the
    rlc pseudo-symbol at iM = max+1), packed table + run-coded bitstream."""
    data = np.asarray(data, np.uint16)
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    im = int(np.nonzero(freq)[0][0]) if freq.any() else 0
    iM = int(np.nonzero(freq)[0][-1]) if freq.any() else 0
    iM += 1              # run-length pseudo-symbol
    freq[iM] = 1
    lengths = _build_code_lengths(freq)
    hcode = lengths.copy()
    _build_canonical_codes(hcode)

    bw = _BitWriter()
    _pack_enc_table(bw, lengths, im, iM)
    bw.pad_to_byte()
    table_bytes = len(bw.out)

    def send(sym):
        code = int(hcode[sym])
        bw.put_bits(code >> 6, code & 63)

    n = len(data)
    i = 0
    while i < n:
        sym = int(data[i])
        send(sym)
        run = 0
        while i + 1 + run < n and run < 255 and int(data[i + 1 + run]) == sym:
            run += 1
        # Emit a run code when it's shorter than repeating the symbol code.
        if run * (int(hcode[sym]) & 63) > (int(hcode[iM]) & 63) + 8 and run > 0:
            send(iM)
            bw.put_bits(run, 8)
            i += 1 + run
        else:
            i += 1
    nbits = bw.bit_count - table_bytes * 8
    payload = bw.bytes()
    head = struct.pack("<iiiii", im, iM, table_bytes, nbits, 0)
    return head + payload


def bitmap_from_data(data: np.ndarray):
    """bitmapFromData: presence bits for every nonzero u16 value."""
    present = np.zeros(1 << 16, bool)
    present[data] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if len(nz) == 0:
        return bitmap, 1, 0  # empty range (minNz > maxNz)
    return bitmap, int(nz[0]), int(nz[-1])


def forward_lut_from_bitmap(bitmap: np.ndarray):
    """forwardLutFromBitmap: lut[value] = compact index; returns max index."""
    bits = np.unpackbits(bitmap, bitorder="little")[: 1 << 16].copy()
    bits[0] = 1
    present = np.nonzero(bits)[0]
    lut = np.zeros(1 << 16, np.uint16)
    lut[present] = np.arange(len(present), dtype=np.uint16)
    return lut, len(present) - 1


def piz_compress(raw: bytes, channels, width: int, n_lines: int) -> bytes:
    """Compress one scanline block (inverse of piz_uncompress)."""
    sizes = {0: 2, 1: 1, 2: 2}
    chan_info = [(name, ptype, sizes[ptype]) for name, ptype in channels]
    line_u16 = sum(width * n16 for _, _, n16 in chan_info)
    flat = np.frombuffer(raw, np.uint16).copy()
    assert len(flat) == line_u16 * n_lines, (len(flat), line_u16, n_lines)

    # De-interleave scanlines into per-channel planes.
    planes = []
    pos = 0
    rows = flat.reshape(n_lines, line_u16)
    col = 0
    for name, ptype, n16 in chan_info:
        w16 = width * n16
        planes.append(rows[:, col : col + w16].reshape(-1).copy())
        col += w16

    allv = np.concatenate(planes)
    bitmap, min_nz, max_nz = bitmap_from_data(allv)
    lut, max_value = forward_lut_from_bitmap(bitmap)

    out = bytearray()
    out += struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz : max_nz + 1].tobytes()

    enc_planes = []
    for (name, ptype, n16), plane in zip(chan_info, planes):
        plane = lut[plane]
        for j in range(n16):
            wav2_encode(plane[j:], width, n16, n_lines, width * n16, max_value)
        enc_planes.append(plane)
    huf = huf_compress(np.concatenate(enc_planes))
    out += struct.pack("<i", len(huf))
    out += huf
    return bytes(out)
