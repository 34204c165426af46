"""The port's host resize: PIL's default ``Image.resize`` (bicubic in Pillow
12) as a PyTorch call on uint8, so resizing needs no PIL.

The JAX package resizes with PIL in three places (``slide_io.py:105``,
``extract.py:144``, ``decode_pool.py:69``). ``F.interpolate`` on uint8 in
channels-last layout with ``mode="bicubic", antialias=True`` runs PyTorch's
port of Pillow's resampler; its 16-bit filter weights (PIL keeps 22 bits)
leave at most 1 in a small share of the values
(``tests/test_torch_preprocess.py``). ``mode="bilinear"`` is not PIL's
filter and is off by up to 19.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``(H, W, C)`` uint8 -> ``(h, w, C)`` uint8 for ``size = (w, h)``, as
    ``PIL.Image.resize(size)`` does; a copy when the size is unchanged."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_u8: expects (H, W, C) uint8, got {img.shape} {img.dtype}")
    if img.shape[:2] == (h, w):
        return img.copy()
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]  # NCHW view, NHWC memory
    out = F.interpolate(x, size=(h, w), mode="bicubic", antialias=True, align_corners=False)
    return np.ascontiguousarray(out[0].permute(1, 2, 0).numpy())
