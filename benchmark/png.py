"""Reads back the PNG a served request returned: 8-bit RGB, not interlaced,
any of the five row filters, every chunk's CRC checked."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def size(data: bytes):
    """(width, height) from the IHDR chunk, or None when ``data`` is no PNG."""
    if len(data) < 24 or data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", data[16:24])


def decode_rgb(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3]; raises ValueError on anything else."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, ihdr, idat = 8, None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or ihdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG: {ihdr}")
    w, h = ihdr[0], ihdr[1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.uint8)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 1:
            cur = np.cumsum(row.reshape(w, 3), axis=0).reshape(-1) & 0xFF
        elif f == 2:
            cur = (row + prev) & 0xFF
        elif f in (3, 4):
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b, c = prev[x], (prev[x - 3] if x >= 3 else 0)
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad row filter {f}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)
