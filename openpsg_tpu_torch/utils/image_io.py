"""Image files without a native codec: a PNG writer and reader on Python's
``zlib``, and :func:`load_image_rgb`.

The JAX package reads images with cv2 and writes submission PNGs through
its C++ ``encode_palette_png`` (``openpsg_tpu/native``).  The port needs
neither: it writes 8-bit palette PNGs (colour type 3) and truecolour PNGs
(colour type 2), each row with filter 0, and reads 8-bit non-interlaced
PNGs of colour types 2, 3 and 6 (alpha dropped) with any of the five row
filters.  :func:`load_image_rgb` decodes through cv2 where cv2 can be
imported, so pixels agree with the reference's decoder (JPEG included), and
through the PNG reader otherwise.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 3: 1, 6: 4}   # colour type → bytes per pixel at 8 bits


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode(pixels: np.ndarray, colour_type: int, palette: Optional[np.ndarray] = None) -> bytes:
    h, w = pixels.shape[:2]
    rows = np.ascontiguousarray(pixels, np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)   # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    out = PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b"")


def encode_palette_png(idx: np.ndarray, palette_rgb: np.ndarray) -> bytes:
    """[h, w] uint8 palette indices + [n ≤ 256, 3] uint8 RGB palette → PNG
    bytes (8-bit colour type 3; readers expand it to RGB)."""
    pal = np.asarray(palette_rgb, np.uint8)
    assert pal.ndim == 2 and pal.shape[1] == 3 and 1 <= pal.shape[0] <= 256, pal.shape
    assert idx.ndim == 2
    return _encode(idx, 3, pal)


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """[h, w, 3] uint8 RGB → PNG bytes (8-bit colour type 2)."""
    assert rgb.ndim == 3 and rgb.shape[2] == 3, rgb.shape
    return _encode(rgb, 2)


def write_png(path: str, png: bytes) -> None:
    with open(path, "wb") as f:
        f.write(png)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw [h, 1 + stride] → [h, stride]."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, row = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = row
        elif ftype == 1:     # Sub: running sum along the row, per byte lane
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64) & 255)
            cur = cur.astype(np.uint8).reshape(-1)
        elif ftype == 2:     # Up
            cur = row + prev
        elif ftype in (3, 4):   # Average, Paeth: sequential along the row
            r, p, c = row.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    c[x] = (r[x] + ((a + p[x]) >> 1)) & 255
                else:
                    c[x] = (r[x] + _paeth(a, p[x], p[x - bpp] if x >= bpp else 0)) & 255
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [h, w, 3] uint8 RGB.  8-bit, non-interlaced, colour types
    2 (RGB), 3 (palette) and 6 (RGBA, alpha dropped)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit, types 2/3/6, non-interlaced only)")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    pix = _unfilter(raw, bpp).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[pix[..., 0]]
    return np.ascontiguousarray(pix[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def image_decoder() -> str:
    """Which decoder :func:`load_image_rgb` uses here."""
    return "cv2" if _cv2() is not None else "png (openpsg_tpu_torch.utils.image_io)"


def load_image_rgb(path: str) -> np.ndarray:
    """Image file → [h, w, 3] uint8 RGB: cv2 where it can be imported (the
    reference's decoder, so pixels agree), else the PNG reader."""
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return bgr[..., ::-1].copy()
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise RuntimeError(
            f"{path}: not a PNG, and cv2 is not installed; without cv2 the port "
            "decodes PNG files only (JPEG needs cv2)")
    return decode_png(data)
