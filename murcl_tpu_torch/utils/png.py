"""PNG writer on the standard library (``zlib``, ``struct``): the port's
counterpart of ``cv2.imwrite`` for the heatmaps, the tiling overview and
masks, and the tissue masks, so that writing one needs neither OpenCV nor
PIL.
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
