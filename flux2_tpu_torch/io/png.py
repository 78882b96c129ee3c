"""8-bit RGB PNG encode/decode with the standard library (zlib + struct).

The JAX server writes PNGs with Pillow; the port's hosts may have none, so
it writes the same image itself: one IDAT chunk, filter type 0 on every row.
``decode_png`` reads back exactly that format (8-bit RGB, no interlace,
filter 0), which is what the tests and the chip smoke check need.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(image_u8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes."""
    image_u8 = np.ascontiguousarray(image_u8, dtype=np.uint8)
    if image_u8.ndim != 3 or image_u8.shape[2] != 3:
        raise ValueError(f"want uint8 [H, W, 3], got {image_u8.shape}")
    h, w, _ = image_u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image_u8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolour, no interlace
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by ``encode_png`` -> uint8 [H, W, 3]. Checks the
    signature, each chunk's CRC and the IHDR fields; raises ValueError on
    anything else."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG: bad signature")
    pos, ihdr, idat = 8, None, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or ihdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {ihdr}")
    w, h = ihdr[0], ihdr[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError("unsupported PNG row filter")
    return rows[:, 1:].reshape(h, w, 3).copy()
