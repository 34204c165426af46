"""PNG writer on the standard library (``zlib``, ``struct``): the port's
counterpart of ``cv2.imwrite`` for the heatmaps, so that writing one needs
neither OpenCV nor PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, bgr: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 BGR image (OpenCV's channel order) as an
    8-bit RGB PNG that ``cv2.imread`` reads back as the same array, at zlib
    level 1, ``cv2.imwrite``'s default compression."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"write_png: expects (H, W, 3) uint8, got {bgr.shape} {bgr.dtype}")
    h, w, _ = bgr.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = bgr[..., ::-1].reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
