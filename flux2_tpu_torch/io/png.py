"""8-bit PNG encode/decode with the standard library (zlib + struct).

The JAX server writes PNGs with Pillow; the port's hosts may have none, so
it writes the same image itself: one IDAT chunk, filter type 0 on every row.
``to_u8`` is the float-to-pixel conversion of every JAX writer (the CLI's
``_save_image``, the server's PNGs and previews): clip to [0, 1], scale by
255 and truncate; the port's PNG writers all go through it.
``decode_png`` reads 8-bit, non-interlaced grey, grey + alpha, RGB and RGBA
with any of the five row filters (what Pillow and most encoders write) and
returns RGB, the alpha dropped as Pillow's ``convert("RGB")`` drops it.
``decode_image`` is the reference-image reader of the CLI and the server:
Pillow where it imports, as JAX's reads every image; without Pillow, PNG
through ``decode_png`` and nothing else.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def to_u8(image: np.ndarray) -> np.ndarray:
    """Float image in [0, 1] -> uint8 as the JAX package's writers convert it:
    ``(np.clip(image, 0, 1) * 255).astype(np.uint8)``, truncating."""
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


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


# IHDR colour type -> samples per pixel (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` [h, 1 + stride] -> uint8 [h, stride].

    A pixel's bytes depend on the pixel to its left, above and above-left
    (each filter reads a subset of those three), so the pixels of one
    anti-diagonal, row + column = d, depend only on earlier diagonals. The
    image is skewed so that diagonal d is one contiguous row, and each of the
    h + w - 1 diagonals is undone at once with numpy, whatever its rows'
    filters."""
    kinds = raw[:, 0].astype(np.intp)
    if h and kinds.max() > 4:
        raise ValueError(f"bad PNG row filter {int(kinds.max())}")
    w = stride // bpp
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    filt = np.zeros((h + w, h, bpp), np.int16)  # filt[y + x, y] = the filtered pixel (y, x)
    filt[ys + xs, ys] = raw[:, 1:].reshape(h, w, bpp)
    # out[1 + y + x, 1 + y] = pixel (y, x); row 0, column 0 and the last row
    # (read as row -1 at d = 0) stay zero: what the filters read above the
    # first image row and left of the first image column
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a, b, c = out[d, y0 + 1 : y1 + 1], out[d, y0:y1], out[d - 1, y0:y1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[y0:y1, None], [0, a, b, (a + b) >> 1, paeth])
        out[d + 1, y0 + 1 : y1 + 1] = (filt[d, y0:y1] + pred) & 0xFF
    return out[1 + ys + xs, 1 + ys].reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] (see the module docstring for what it
    reads). Checks the signature, each chunk's CRC and the IHDR fields;
    raises ValueError on anything else."""
    px = decode_png_pixels(data)
    if px.shape[2] in (1, 2):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return px[:, :, :3].copy()


def decode_png_pixels(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] as stored: C = 1 (grey), 2 (grey +
    alpha), 3 (RGB) or 4 (RGBA)."""
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
    if ihdr is None or ihdr[2] != 8 or ihdr[3] not in _CHANNELS or ihdr[4:] != (0, 0, 0):
        raise ValueError(f"unsupported PNG header {ihdr}: 8-bit grey, grey+alpha, RGB or RGBA, not interlaced")
    w, h, ch = ihdr[0], ihdr[1], _CHANNELS[ihdr[3]]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> float32 [H, W, 3] in [0, 1] (RGB, u8 / 255):
    through Pillow's ``convert("RGB")`` where Pillow imports, else a PNG
    through ``decode_png``."""
    try:
        from PIL import Image
    except ImportError:
        if data[:8] != PNG_SIGNATURE:
            raise ValueError("only PNG images can be read without Pillow (PIL); this image is not a PNG") from None
        u8 = decode_png(data)
    else:
        with Image.open(io.BytesIO(data)) as im:
            u8 = np.asarray(im.convert("RGB"))
    return u8.astype(np.float32) / 255.0
