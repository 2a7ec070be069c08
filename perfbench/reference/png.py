"""A reader of 8-bit, non-interlaced PNG files (zlib and numpy only)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """`[H, W, C]` uint8; ValueError on a file that is not a valid 8-bit,
    non-interlaced PNG (signature, chunk CRCs, IHDR, the inflated
    length and the filter bytes are checked)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr, tags = 8, b"", None, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        tags.append(tag)
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if not tags or tags[0] != b"IHDR" or tags[-1] != b"IEND":
        raise ValueError(f"{path}: chunks {tags}")
    W, H, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or ctype not in CHANNELS:
        raise ValueError(f"{path}: IHDR {ihdr} is not 8-bit, "
                         "non-interlaced grey or RGB(A)")
    C = CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != H * (1 + stride):
        raise ValueError(f"{path}: {raw.size} inflated bytes, want "
                         f"{H * (1 + stride)}")
    rows = raw.reshape(H, 1 + stride)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: filter byte above 4")
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for r in range(H):
        f, line = rows[r, 0], rows[r, 1:].astype(np.int64)
        if f == 0:
            cur = line
        elif f == 1:
            cur = np.zeros(stride, np.int64)
            for c in range(C):
                cur[c::C] = np.cumsum(line[c::C]) & 255
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = cur[i - C] if i >= C else 0
                c = prev[i - C] if i >= C else 0
                pred = (a + prev[i]) // 2 if f == 3 else _paeth(a, prev[i], c)
                cur[i] = (line[i] + pred) & 255
        out[r] = cur
        prev = cur
    return out.reshape(H, W, C)
