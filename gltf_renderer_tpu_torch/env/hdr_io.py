"""HDR image IO: Radiance .hdr (RGBE) and OpenEXR readers and writers (numpy).

Copy of gltf_renderer_tpu/env/hdr_io.py; PIZ blocks decode through the
native decoder (env/piz.py). The reference uses stb_image
(EnvironmentMap.cpp:253-289) for .hdr and tinyexr (EnvironmentMap.cpp:148-251)
for .exr. No OpenEXR binding is used: both formats are parsed directly,
RGBE with new-style RLE, and EXR scanline and tiled images (half / float /
uint channels) with every compression tinyexr itself decodes — NONE, RLE,
ZIPS, ZIP, PIZ — plus PXR24, which tinyexr does NOT support, so the loader
envelope strictly contains the reference's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)
# ---------------------------------------------------------------------------

def read_hdr(path: str) -> np.ndarray:
    """Returns (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # Header ends with a blank line; next line is the resolution.
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res_line = data[pos:eol].decode("ascii").split()
    if res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(res_line)}")
    height, width = int(res_line[1]), int(res_line[3])
    pos = eol + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(height):
        # New-style RLE scanline?
        if width >= 8 and width < 32768 and buf[pos] == 2 and buf[pos + 1] == 2:
            if (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) != width:
                raise ValueError("HDR scanline width mismatch")
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos])
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[pos + 1]
                        x += count - 128
                        pos += 2
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[pos + 1 : pos + 1 + count]
                        x += count
                        pos += 1 + count
        else:
            flat = buf[pos : pos + width * 4].reshape(width, 4)
            rgbe[y] = flat
            pos += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] > 0, 1.0, 0.0
    ).astype(np.float32)


def write_hdr(path: str, image: np.ndarray):
    """Write (H, W, 3) float32 as uncompressed RGBE (for tests/tools)."""
    image = np.maximum(np.asarray(image, np.float32), 0.0)
    h, w = image.shape[:2]
    maxc = image.max(-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float64)
    nz = maxc > 1e-32
    m, e = np.frexp(maxc[nz])
    scale = (256.0 / maxc[nz]) * m
    rgbe = np.zeros((h, w, 4), np.uint8)
    vals = np.clip(image[nz] * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[nz, :3] = vals
    rgbe[nz, 3] = (e + 128).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------------
# OpenEXR (scanline, NONE/RLE/ZIPS/ZIP/PIZ/PXR24)
# ---------------------------------------------------------------------------

_PIXEL_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}


def _zip_reconstruct(raw: bytes) -> bytes:
    """Invert the shared ZIP/RLE byte transform (OpenEXR ImfZip.cpp /
    ImfRleCompressor.cpp): un-delta (d[i] = d[i-1] + raw[i] - 128, d[0] =
    raw[0]) then de-interleave the two halves."""
    b = np.frombuffer(raw, np.uint8).astype(np.int64)
    d = np.mod(np.cumsum(b - 128) + 128, 256).astype(np.uint8)
    half = (len(d) + 1) // 2
    inter = np.zeros(len(d), np.uint8)
    inter[0::2] = d[:half]
    inter[1::2] = d[half:]
    return inter.tobytes()


def _zip_forward(raw: bytes) -> bytes:
    """Forward ZIP/RLE byte transform (interleave-split then delta) — the
    encoder side of _zip_reconstruct, used by write_exr."""
    b = np.frombuffer(raw, np.uint8)
    half = (len(b) + 1) // 2
    split = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = np.empty(len(split), np.int64)
    d[0] = split[0]
    d[1:] = split[1:] - split[:-1] + 128
    return np.mod(d, 256).astype(np.uint8).tobytes()


def _rle_uncompress(raw: bytes, expect: int) -> bytes:
    """OpenEXR RLE codec (ImfRle.cpp rleUncompress): signed count byte,
    negative n => -n literal bytes follow, non-negative n => n+1 copies of
    the next byte."""
    src = np.frombuffer(raw, np.int8)
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expect:
        c = int(src[i])
        if c < 0:
            out += raw[i + 1 : i + 1 - c]
            i += 1 - c
        else:
            out += raw[i + 1 : i + 2] * (c + 1)
            i += 2
    if len(out) != expect:
        raise ValueError("EXR RLE decode size mismatch")
    return bytes(out)


def _rle_compress(raw: bytes) -> bytes:
    """Valid (not byte-identical-to-OpenEXR) RLE encoder for write_exr:
    emit runs of >=3 equal bytes, literals otherwise."""
    out = bytearray()
    i, n = 0, len(raw)
    lit_start = 0

    def flush_literals(end):
        s = lit_start
        while s < end:
            chunk = min(127, end - s)
            out.append((256 - chunk) & 0xFF)  # -chunk as signed byte
            out.extend(raw[s : s + chunk])
            s += chunk

    while i < n:
        run = 1
        while i + run < n and raw[i + run] == raw[i] and run < 128:
            run += 1
        if run >= 3:
            flush_literals(i)
            out.append(run - 1)
            out.append(raw[i])
            i += run
            lit_start = i
        else:
            i += run
    flush_literals(n)
    return bytes(out)


def _pxr24_uncompress(raw: bytes, channels_sorted, width: int, n_lines: int) -> bytes:
    """PXR24 (ImfPxr24Compressor.cpp): zlib over per-scanline, per-channel
    byte planes of horizontally delta-coded pixels; floats truncated to 24
    bits (bits >> 8). Returns raw bytes in the standard scanline-interleaved
    channel layout (floats rehydrated as f32 with the low mantissa byte 0)."""
    data = zlib.decompress(raw)
    pos = 0
    out = bytearray()
    for _li in range(n_lines):
        for _cname, ctype in channels_sorted:
            if ctype == 2:  # FLOAT: 3 planes of the 24-bit value
                p = np.frombuffer(data, np.uint8, 3 * width, pos).reshape(3, width)
                pos += 3 * width
                diff = (
                    (p[0].astype(np.uint32) << 16)
                    | (p[1].astype(np.uint32) << 8)
                    | p[2]
                )
                px = np.cumsum(diff, dtype=np.uint32) & 0xFFFFFF
                out += (px << 8).astype("<u4").tobytes()
            elif ctype == 1:  # HALF: 2 planes, lossless
                p = np.frombuffer(data, np.uint8, 2 * width, pos).reshape(2, width)
                pos += 2 * width
                diff = ((p[0].astype(np.uint16) << 8) | p[1]).astype(np.uint16)
                out += np.cumsum(diff, dtype=np.uint16).astype("<u2").tobytes()
            else:  # UINT: 4 planes
                p = np.frombuffer(data, np.uint8, 4 * width, pos).reshape(4, width)
                pos += 4 * width
                diff = (
                    (p[0].astype(np.uint32) << 24)
                    | (p[1].astype(np.uint32) << 16)
                    | (p[2].astype(np.uint32) << 8)
                    | p[3]
                )
                out += np.cumsum(diff, dtype=np.uint32).astype("<u4").tobytes()
    return bytes(out)


def _pxr24_compress(raw: bytes, channels_sorted, width: int, n_lines: int) -> bytes:
    """Encoder side of _pxr24_uncompress (floats truncated, per ImfPxr24
    floatToFloat24 minus its round-to-nearest — any 24-bit value round-trips)."""
    planes = bytearray()
    pos = 0
    for _li in range(n_lines):
        for _cname, ctype in channels_sorted:
            if ctype == 2:
                px = np.frombuffer(raw, "<u4", width, pos) >> 8
                pos += 4 * width
                diff = np.diff(px, prepend=np.uint32(0)).astype(np.uint32)
                planes += ((diff >> 16) & 0xFF).astype(np.uint8).tobytes()
                planes += ((diff >> 8) & 0xFF).astype(np.uint8).tobytes()
                planes += (diff & 0xFF).astype(np.uint8).tobytes()
            elif ctype == 1:
                px = np.frombuffer(raw, "<u2", width, pos)
                pos += 2 * width
                diff = np.diff(px, prepend=np.uint16(0)).astype(np.uint16)
                planes += (diff >> 8).astype(np.uint8).tobytes()
                planes += (diff & 0xFF).astype(np.uint8).tobytes()
            else:
                px = np.frombuffer(raw, "<u4", width, pos)
                pos += 4 * width
                diff = np.diff(px, prepend=np.uint32(0)).astype(np.uint32)
                for sh in (24, 16, 8, 0):
                    planes += ((diff >> sh) & 0xFF).astype(np.uint8).tobytes()
    return zlib.compress(bytes(planes))


def _read_exr_header(data, pos):
    attrs = {}
    while True:
        if data[pos] == 0:
            return attrs, pos + 1
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        atype = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = (atype, data[pos : pos + size])
        pos += size


def _decompress_block(data, comp, channels_sorted, width, n_lines, raw, size):
    """One scanline block / tile payload -> raw interleaved channel lines."""
    bytes_per_px = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(bytes_per_px[t] * width for _, t in channels_sorted)
    expect = line_bytes * n_lines
    if size >= expect and comp != 0:
        pass  # stored uncompressed (compression didn't help)
    elif comp == 1:
        raw = _zip_reconstruct(_rle_uncompress(raw, expect))
    elif comp in (2, 3):
        raw = _zip_reconstruct(zlib.decompress(raw))
    elif comp == 4:
        from gltf_renderer_tpu_torch.env.piz import piz_uncompress

        raw = piz_uncompress(raw, list(channels_sorted), width, n_lines)
    elif comp == 5:
        raw = _pxr24_uncompress(raw, channels_sorted, width, n_lines)
    if len(raw) != expect:
        raise ValueError("EXR block size mismatch")
    return raw


def _num_tiles(size: int, level: int, tile: int, round_up: bool) -> int:
    """Tile count along one axis at a mip/rip level (OpenEXR tiledesc)."""
    d = 1 << level
    lv = max(1, (size + d - 1) // d if round_up else size // d)
    return -(-lv // tile)


def _tile_offset_count(width, height, tx, ty, mode, round_up) -> int:
    """Total chunk-offset count for ONE_LEVEL / MIPMAP / RIPMAP tilings."""
    if mode == 0:  # ONE_LEVEL
        return _num_tiles(width, 0, tx, round_up) * _num_tiles(height, 0, ty, round_up)
    n_lx = max(width - 1, 1).bit_length() if width > 1 else 1
    n_ly = max(height - 1, 1).bit_length() if height > 1 else 1
    # number of levels: floor/ceil(log2(max dim)) + 1
    def n_levels(s):
        n, lv = 1, s
        while lv > 1:
            lv = (lv + 1) // 2 if round_up else lv // 2
            n += 1
        return n
    if mode == 1:  # MIPMAP: square level pairs over max(w, h)
        levels = max(n_levels(width), n_levels(height))
        return sum(
            _num_tiles(width, l, tx, round_up) * _num_tiles(height, l, ty, round_up)
            for l in range(levels)
        )
    if mode == 2:  # RIPMAP: all (lx, ly) combinations
        return sum(
            _num_tiles(width, lx, tx, round_up) * _num_tiles(height, ly, ty, round_up)
            for lx in range(n_levels(width))
            for ly in range(n_levels(height))
        )
    raise ValueError(f"EXR tile level mode {mode} not supported")


def read_exr(path: str) -> np.ndarray:
    """Returns (H, W, C<=4) float32 (channels in R, G, B, A order if named so).

    Scanline AND tiled single-part files (the reference's tinyexr loads
    tiled single-part EXRs, EnvironmentMap.cpp:148-251 — real 4k HDRIs from
    the wild are often tiled): for tiled files the level-0 tiles are
    decoded; mip/rip levels beyond 0 are skipped (the env pipeline builds
    its own pyramids). Multi-part and deep files are rejected.
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != 20000630:
        raise ValueError("not an EXR file")
    if version & 0x1000 or version & 0x800:
        raise ValueError("multi-part / deep EXR not supported")
    tiled = bool(version & 0x200)
    attrs, pos = _read_exr_header(data, 8)

    # Channels.
    chan_data = attrs["channels"][1]
    channels = []
    cpos = 0
    while chan_data[cpos] != 0:
        end = chan_data.index(b"\x00", cpos)
        cname = chan_data[cpos:end].decode()
        cpos = end + 1
        ctype, _plin, _x, _y = struct.unpack_from("<iBxxxii", chan_data, cpos)
        cpos += 16
        channels.append((cname, ctype))
    channels_sorted = sorted(channels)  # EXR stores channels alphabetically

    comp = attrs["compression"][1][0]
    if comp not in (0, 1, 2, 3, 4, 5):
        raise ValueError(
            f"EXR compression {comp} not supported (none/rle/zips/zip/piz/pxr24)"
        )
    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}[comp]

    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    width = xmax - xmin + 1
    height = ymax - ymin + 1

    out = {name: np.zeros((height, width), np.float32) for name, _ in channels}
    bytes_per_px = {0: 4, 1: 2, 2: 4}

    def store_lines(raw, x0, y0, w_run, n_lines):
        bpos = 0
        for li in range(n_lines):
            for cname, ctype in channels_sorted:
                line = np.frombuffer(raw, _PIXEL_DTYPE[ctype], count=w_run,
                                     offset=bpos)
                out[cname][y0 + li, x0 : x0 + w_run] = line.astype(np.float32)
                bpos += bytes_per_px[ctype] * w_run

    if tiled:
        # tiledesc: xSize, ySize (u32), mode byte = levelMode | rounding<<4.
        tx, ty, mode_b = struct.unpack_from("<IIB", attrs["tiles"][1], 0)
        mode, round_up = mode_b & 0xF, bool(mode_b >> 4)
        n_off = _tile_offset_count(width, height, tx, ty, mode, round_up)
        offsets = struct.unpack_from(f"<{n_off}Q", data, pos)
        for off in offsets:
            # Tile chunks are self-describing: dx, dy, levelx, levely, size.
            dx, dy, lx, ly, size = struct.unpack_from("<iiiii", data, off)
            if lx != 0 or ly != 0:
                continue  # mip/rip levels beyond 0: env builds its own
            raw = data[off + 20 : off + 20 + size]
            x0, y0 = dx * tx, dy * ty
            w_run = min(tx, width - x0)
            n_lines = min(ty, height - y0)
            raw = _decompress_block(data, comp, channels_sorted, w_run,
                                    n_lines, raw, size)
            store_lines(raw, x0, y0, w_run, n_lines)
    else:
        n_blocks = -(-height // lines_per_block)
        offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
        for off in offsets:
            y, size = struct.unpack_from("<ii", data, off)
            raw = data[off + 8 : off + 8 + size]
            n_lines = min(lines_per_block, ymax - y + 1)
            raw = _decompress_block(data, comp, channels_sorted, width,
                                    n_lines, raw, size)
            store_lines(raw, 0, y - ymin, width, n_lines)

    order = [c for c in ("R", "G", "B", "A") if c in out]
    if not order:
        order = [channels[0][0]]
    return np.stack([out[c] for c in order], -1)


def write_exr(path: str, image: np.ndarray, compression: int = 0, half: bool = False,
              tile: "tuple[int, int] | None" = None):
    """Scanline (or, with tile=(tx, ty), ONE_LEVEL-tiled) EXR writer for
    tests/tools. compression: 0=none, 1=rle, 2=zips, 3=zip, 4=piz, 5=pxr24
    (floats truncated to 24 bits, halves lossless)."""
    if compression not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"write_exr: unsupported compression {compression}")
    image = np.asarray(image, np.float16 if half else np.float32)
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    names = ["Y"] if c == 1 else ["R", "G", "B", "A"][:c]
    chans = sorted(names)
    ctype = 1 if half else 2
    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}[compression]

    def attr(name, atype, payload):
        return name.encode() + b"\x00" + atype.encode() + b"\x00" + struct.pack("<I", len(payload)) + payload

    chan_payload = b""
    for n in chans:
        chan_payload += n.encode() + b"\x00" + struct.pack("<iBxxxii", ctype, 0, 1, 1)
    chan_payload += b"\x00"

    header = b""
    header += attr("channels", "chlist", chan_payload)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    if tile is not None:
        header += attr("tiles", "tiledesc",
                       struct.pack("<IIB", tile[0], tile[1], 0))
    header += b"\x00"

    img = image.reshape(h, w, c)
    name_to_idx = {n: i for i, n in enumerate(names)}
    channels_sorted = [(n, ctype) for n in chans]

    def encode(raw, w_run, n_lines):
        if compression == 1:
            enc = _rle_compress(_zip_forward(raw))
        elif compression in (2, 3):
            enc = zlib.compress(_zip_forward(raw))
        elif compression == 4:
            from gltf_renderer_tpu_torch.env.piz import piz_compress

            enc = piz_compress(raw, channels_sorted, w_run, n_lines)
        elif compression == 5:
            enc = _pxr24_compress(raw, channels_sorted, w_run, n_lines)
        else:
            enc = raw
        return enc if len(enc) < len(raw) else raw

    blocks = []  # (chunk header bytes sans size, payload)
    if tile is not None:
        tx, ty = tile
        for dy in range(-(-h // ty)):
            for dx in range(-(-w // tx)):
                x0, y0 = dx * tx, dy * ty
                w_run, n_lines = min(tx, w - x0), min(ty, h - y0)
                raw = b"".join(
                    img[y0 + li, x0 : x0 + w_run, name_to_idx[n]].tobytes()
                    for li in range(n_lines)
                    for n in chans
                )
                blocks.append((struct.pack("<iiii", dx, dy, 0, 0),
                               encode(raw, w_run, n_lines)))
    else:
        for bi in range(-(-h // lines_per_block)):
            y0 = bi * lines_per_block
            n_lines = min(lines_per_block, h - y0)
            raw = b"".join(
                img[y0 + li, :, name_to_idx[n]].tobytes()
                for li in range(n_lines)
                for n in chans
            )
            blocks.append((struct.pack("<i", y0), encode(raw, w, n_lines)))

    n_blocks = len(blocks)
    table_pos = 8 + len(header)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    for hdr_bytes, payload in blocks:
        offsets.append(data_pos)
        data_pos += len(hdr_bytes) + 4 + len(payload)
    version = 2 | (0x200 if tile is not None else 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<iI", 20000630, version))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for hdr_bytes, payload in blocks:
            f.write(hdr_bytes + struct.pack("<i", len(payload)))
            f.write(payload)


def read_environment_image(path: str) -> np.ndarray:
    """Dispatch on extension -> (H, W, 3) float32 equirect radiance."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        return read_hdr(path)[..., :3]
    if lower.endswith(".exr"):
        img = read_exr(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        return img[..., :3]
    raise ValueError(f"unsupported environment image: {path}")
