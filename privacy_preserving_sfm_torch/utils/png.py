"""A small PNG codec on the standard library (``zlib``, ``struct``) and numpy.

It reads 8-bit non-interlaced PNGs of colour types 0 (grayscale), 2 (RGB),
3 (palette), 4 (grayscale + alpha) and 6 (RGBA), with all five row
filters, and writes 8-bit grayscale.  The front end uses it to read PNG
images where PIL is not installed; ``read_png_gray`` converts to
grayscale with PIL's own integer luma, ``(19595 R + 38470 G + 7471 B +
0x8000) >> 16``, so both readers give the same bytes.

Rows that use only the None, Sub and Up filters are undone one row at a
time.  Average and Paeth predict each byte from the reconstructed byte to
its left, so an image with such rows is undone along anti-diagonals
(pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), all on the two
diagonals before it): H + W - 1 vector steps instead of a per-byte loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, filt, bpp):
    """Rows of filters None, Sub and Up, one vectorized row at a time."""
    out = np.empty_like(filt)
    prev = np.zeros(filt.shape[1], np.uint8)
    for y, t in enumerate(ftype):
        row = filt[y]
        if t == 1:
            row = row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8
                                              ).reshape(-1)
        elif t == 2:
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_diagonals(ftype, filt, bpp):
    """Any mix of the five filters, one anti-diagonal of pixels a step."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int16)
    # r[y + 1, x + 1] is the reconstructed pixel (y, x); row 0 and column 0
    # are the zeros the filters read outside the image.
    r = np.zeros((h + 1, w + 1, bpp), np.int16)
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        xs = t - ys
        a, b, c = r[ys + 1, xs], r[ys, xs + 1], r[ys, xs]
        kind = ftype[ys][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        r[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return r[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to uint8: (H, W) grayscale,
    (H, W, 2) grayscale + alpha, (H, W, 3) RGB (palette images expanded
    through their palette) or (H, W, 4) RGBA."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in CHANNELS:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace "
            f"{interlace}; only 8-bit non-interlaced PNGs of colour type 0, "
            "2, 3, 4 or 6 are read without PIL")
    bpp = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:height * (width * bpp + 1)].reshape(height, -1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if np.any(ftype > 4):
        raise ValueError(f"{path}: unknown PNG row filter")
    if np.any(ftype > 2):
        img = _unfilter_diagonals(ftype, filt, bpp)
    else:
        img = _unfilter_rows(ftype, filt, bpp)
    img = img.reshape(height, width, bpp)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        full = np.zeros((256, 3), np.uint8)  # missing entries are black
        full[:len(palette)] = palette[:256]
        return full[img[..., 0]]
    return img[..., 0] if bpp == 1 else img


def to_gray(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of a ``read_png`` result: alpha dropped, RGB
    through the integer luma."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0].copy()
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale of a PNG file, as PIL's ``convert("L")``."""
    return to_gray(read_png(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as an 8-bit grayscale PNG (filter None)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected (H, W) uint8, got shape {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                               0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))
