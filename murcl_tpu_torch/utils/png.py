"""PNG on the standard library (``zlib``, ``struct``) and numpy: the port's
counterpart of ``cv2.imwrite`` for the heatmaps, the tiling overview and
masks, and the tissue masks, and of PIL's reading of a ``.png`` slide, so
that neither needs OpenCV or PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 BGR image (OpenCV's channel order) as an
    8-bit RGB PNG, or an ``(H, W)`` uint8 one as an 8-bit grayscale PNG, that
    ``cv2.imread(path, IMREAD_UNCHANGED)`` reads back as the same array, at
    zlib level 1, ``cv2.imwrite``'s default compression."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: expects (H, W, 3) or (H, W) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    channels, colour = (1, 0) if img.ndim == 2 else (3, 2)  # grayscale / truecolour
    rows = np.zeros((h, 1 + channels * w), dtype=np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = (img if img.ndim == 2 else img[..., ::-1]).reshape(h, channels * w)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples: gray, RGB, RGBA


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB or RGBA PNG as ``(H, W)``, ``(H, W,
    3)`` or ``(H, W, 4)`` uint8 in the file's channel order (RGB), with the
    five row filters undone (None, Sub, Up, Average, Paeth; the last two
    run pixel by pixel in Python). The inverse of :func:`write_png`, whose
    BGR input comes back as RGB."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + 13])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; only 8-bit gray, RGB or RGBA without interlace is read")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {h} rows of {stride}")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour's result
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, up[x], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)
