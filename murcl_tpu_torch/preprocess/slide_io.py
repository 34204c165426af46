"""Slide IO: OpenSlide when importable, a single-level numpy slide otherwise
(counterpart of ``murcl_tpu/preprocess/slide_io.py``: ``ImageSlide``,
``open_slide``, ``get_three_points``).

The port's :class:`ImageSlide` holds an RGB uint8 array and returns numpy
arrays where the JAX class returns PIL images (``read_region`` RGBA,
``get_thumbnail`` RGB). PIL is imported only to read an image file and to
shrink a thumbnail, so a slide supplied as an array needs neither PIL nor
OpenSlide.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

try:  # pragma: no cover - depends on environment
    import openslide as _openslide
except ImportError:  # pragma: no cover
    _openslide = None


class ImageSlide:
    """Single-level slide over an ``(H, W, 3)`` uint8 RGB array, read from
    ``filepath`` with PIL when ``image`` is None. ``properties`` may come
    from a sidecar ``<image>.props.json`` (``aperio.AppMag``,
    ``openslide.mpp-x``), as real slide metadata does."""

    def __init__(self, filepath, image: Optional[np.ndarray] = None,
                 properties: Optional[dict] = None):
        self._filepath = str(filepath)
        if image is None:
            from PIL import Image

            Image.MAX_IMAGE_PIXELS = None
            with Image.open(filepath) as im:
                image = np.asarray(im.convert("RGB"))
        self._image = np.asarray(image, dtype=np.uint8)
        if properties is None:
            sidecar = Path(str(filepath) + ".props.json")
            properties = json.loads(sidecar.read_text()) if sidecar.exists() else {}
        self.properties = properties

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self._image.shape[1], self._image.shape[0]  # (width, height)

    @property
    def level_count(self) -> int:
        return 1

    @property
    def level_dimensions(self):
        return (self.dimensions,)

    @property
    def level_downsamples(self):
        return (1.0,)

    def get_best_level_for_downsample(self, downsample: float) -> int:
        return 0

    def read_region(self, location, level, size) -> np.ndarray:
        """``(h, w, 4)`` RGBA uint8; pixels past the slide are transparent black."""
        assert level == 0, "ImageSlide has a single level"
        x, y = location
        w, h = size
        region = np.zeros((h, w, 4), dtype=np.uint8)
        crop = self._image[max(y, 0):y + h, max(x, 0):x + w]
        region[:crop.shape[0], :crop.shape[1], :3] = crop
        region[:crop.shape[0], :crop.shape[1], 3] = 255
        return region

    def get_thumbnail(self, size) -> np.ndarray:
        """RGB array fitting in ``size`` (w, h) with the aspect kept: a copy at
        the slide's own size or larger, else PIL's Lanczos ``thumbnail``."""
        width, height = self.dimensions
        if size[0] >= width and size[1] >= height:
            return self._image.copy()
        from PIL import Image

        img = Image.fromarray(self._image)
        img.thumbnail(size, Image.LANCZOS)
        return np.asarray(img)


def open_slide(filepath):
    """OpenSlide when available and the format needs it; ImageSlide otherwise."""
    filepath = str(filepath)
    if _openslide is not None:
        try:
            return _openslide.open_slide(filepath)
        except Exception:
            pass
    return ImageSlide(filepath)


def get_three_points(x_step: int, y_step: int, size) -> tuple:
    """Grid cell -> (top_left, bottom_right, center) pixel coordinates."""
    top_left = (int(x_step * size), int(y_step * size))
    bottom_right = (int(top_left[0] + size), int(top_left[1] + size))
    center = ((top_left[0] + bottom_right[0]) // 2, (top_left[1] + bottom_right[1]) // 2)
    return top_left, bottom_right, center
