"""Slide IO: OpenSlide when importable; otherwise the port's own readers
(counterpart of ``murcl_tpu/preprocess/slide_io.py``: ``ImageSlide``,
``open_slide``, ``downsample_image``, ``get_three_points``, ``keep_patch``,
``out_of_bound``).

- :class:`TiffSlide` reads pyramidal ``.tif``/``.tiff``/``.svs`` files with
  OpenSlide's interface (``preprocess/tiff.py``), decoding JPEG tiles on the
  card by nvJPEG (or by PIL for ``device="cpu"``) and every other codec on
  the host, and keeps a bounded cache of decoded tiles.
- :class:`ImageSlide` holds an RGB uint8 array: a ``.png`` read by
  :func:`~murcl_tpu_torch.utils.png.read_png`, an array the caller supplies,
  or any other image PIL reads where PIL imports.

They return numpy arrays where the JAX classes return PIL images
(``read_region`` RGBA, ``get_thumbnail`` RGB).
"""

from __future__ import annotations

import json
import math
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from murcl_tpu_torch.preprocess.resample import resize_u8

try:  # pragma: no cover - depends on environment
    import openslide as _openslide
except ImportError:  # pragma: no cover
    _openslide = None

TIFF_SUFFIXES = (".tif", ".tiff", ".svs")


def _sidecar_properties(filepath) -> dict:
    """``<image>.props.json`` (``aperio.AppMag``, ``openslide.mpp-x``), as
    real slide metadata gives them; empty when absent."""
    sidecar = Path(str(filepath) + ".props.json")
    return json.loads(sidecar.read_text()) if sidecar.exists() else {}


def _thumbnail_size(width: int, height: int, size) -> Optional[Tuple[int, int]]:
    """PIL's ``Image.thumbnail`` size rule: None when the image already fits
    in ``size``, else the largest size within it that keeps the aspect."""
    x, y = (math.floor(v) for v in size)
    if x >= width and y >= height:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


class ImageSlide:
    """Single-level slide over an ``(H, W, 3)`` uint8 RGB array: ``image``,
    or the file at ``filepath`` (a PNG by :func:`read_png`, anything else by
    PIL). ``properties`` may come from a sidecar ``<image>.props.json``."""

    def __init__(self, filepath, image: Optional[np.ndarray] = None,
                 properties: Optional[dict] = None):
        self._filepath = str(filepath)
        if image is None:
            image = _read_image(filepath)
        self._image = np.asarray(image, dtype=np.uint8)
        self.properties = _sidecar_properties(filepath) if properties is None else properties

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
        if level != 0:
            raise ValueError(f"ImageSlide has a single level, not {level}")
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

    def close(self) -> None:
        pass


def _read_image(filepath) -> np.ndarray:
    if str(filepath).lower().endswith(".png"):
        from murcl_tpu_torch.utils.png import read_png

        img = read_png(filepath)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=2)
        return img[..., :3]
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(filepath) as im:
        return np.asarray(im.convert("RGB"))


class TileCache:
    """A thread-safe LRU of decoded tiles, bounded in bytes."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._tiles: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = self.misses = 0

    def get(self, key):
        with self._lock:
            tile = self._tiles.get(key)
            if tile is None:
                self.misses += 1
                return None
            self.hits += 1
            self._tiles.move_to_end(key)
            return tile

    def put(self, key, tile: np.ndarray) -> None:
        if tile.nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._tiles.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._tiles[key] = tile
            self._bytes += tile.nbytes
            while self._bytes > self.max_bytes:
                _, dropped = self._tiles.popitem(last=False)
                self._bytes -= dropped.nbytes


# a read over more blocks than this (a level read whole) decodes each row of
# its blocks on 8 threads: zlib and nvJPEG release the interpreter lock
LARGE_READ = 64


class TiffSlide:
    """A pyramidal TIFF or ``.svs`` slide with OpenSlide's interface.

    Levels are the file's tiled IFDs (:attr:`TiffFile.levels`); their
    downsamples are OpenSlide's, the mean of ``w0 / wk`` and ``h0 / hk``.
    ``read_region`` reads across tile borders from a thread-safe LRU of
    decoded tiles (``cache_bytes``; neighbouring patches share tiles), on 8
    threads for a read of more than ``LARGE_READ`` tiles. JPEG
    tiles are decoded on ``device`` (nvJPEG on a CUDA device, PIL for
    ``"cpu"``), created at the first JPEG tile; other codecs on the host.
    ``properties`` are OpenSlide's (``tiff.slide_properties``), then a
    ``<slide>.props.json`` sidecar's over them."""

    def __init__(self, filepath, device="cpu", cache_bytes: int = 64 << 20):
        from murcl_tpu_torch.preprocess.tiff import TiffFile, slide_properties

        self._filepath = str(filepath)
        self._file = TiffFile(filepath)
        try:
            self._levels = self._file.levels
            for page in self._levels:
                page.check_readable()
        except Exception:
            self._file.close()
            raise
        self.properties = {**slide_properties(self._levels[0]),
                           **_sidecar_properties(filepath)}
        self.device = device
        self.cache = TileCache(cache_bytes)
        self._jpeg = None
        self._jpeg_lock = threading.Lock()

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self):
        return tuple((p.width, p.height) for p in self._levels)

    @property
    def level_downsamples(self):
        w0, h0 = self.dimensions
        return tuple((w0 / w + h0 / h) / 2.0 for w, h in self.level_dimensions)

    def get_best_level_for_downsample(self, downsample: float) -> int:
        """OpenSlide's rule: 0 below level 0's downsample, else the last level
        whose downsample is not above ``downsample``."""
        ds = self.level_downsamples
        if downsample < ds[0]:
            return 0
        for i in range(1, len(ds)):
            if downsample < ds[i]:
                return i - 1
        return len(ds) - 1

    def _jpeg_decoder(self):
        with self._jpeg_lock:
            if self._jpeg is None:
                from murcl_tpu_torch.preprocess.nvjpeg import jpeg_decoder

                self._jpeg = jpeg_decoder(self.device)
            return self._jpeg

    def _block(self, level: int, i: int) -> np.ndarray:
        key = (level, i)
        tile = self.cache.get(key)
        if tile is None:
            page = self._levels[level]
            jpeg = self._jpeg_decoder() if page.compression == 7 else None
            tile = self._file.block(page, i, jpeg)[..., :3]
            self.cache.put(key, tile)
        return tile

    def _read(self, location, level, size):
        """``(rgb (h, w, 3), (x0, y0, x1, y1))``: the region's pixels, black
        past the slide's edge, and the box of them that lies on the slide."""
        page = self._levels[level]
        ds = self.level_downsamples[level]
        x0 = int(math.floor(location[0] / ds)) if level else int(location[0])
        y0 = int(math.floor(location[1] / ds)) if level else int(location[1])
        w, h = int(size[0]), int(size[1])
        rgb = np.zeros((h, w, 3), dtype=np.uint8)
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + w, page.width), min(y0 + h, page.height)
        if xa >= xb or ya >= yb:
            return rgb, (0, 0, 0, 0)
        bw, bh = page.block_w, page.block_h
        across = page.grid[0]
        rows = range(ya // bh, (yb - 1) // bh + 1)
        cols = range(xa // bw, (xb - 1) // bw + 1)
        pool = ThreadPoolExecutor(8) if len(rows) * len(cols) > LARGE_READ else None
        try:
            for by in rows:
                blocks = [by * across + bx for bx in cols]
                tiles = (pool.map(lambda i: self._block(level, i), blocks) if pool
                         else (self._block(level, i) for i in blocks))
                for bx, tile in zip(cols, tiles):
                    tx0, ty0 = bx * bw, by * bh
                    sx, sy = max(xa, tx0), max(ya, ty0)
                    ex, ey = min(xb, tx0 + bw), min(yb, ty0 + tile.shape[0])
                    rgb[sy - y0:ey - y0, sx - x0:ex - x0] = tile[sy - ty0:ey - ty0,
                                                                 sx - tx0:ex - tx0]
        finally:
            if pool is not None:
                pool.shutdown()
        return rgb, (xa - x0, ya - y0, xb - x0, yb - y0)

    def read_region(self, location, level, size) -> np.ndarray:
        """``(h, w, 4)`` RGBA uint8 of ``size`` (w, h) level-``level``
        pixels from ``location`` (x, y) in level-0 pixels (floored to the
        level's grid); transparent black past the slide's edge."""
        rgb, (xa, ya, xb, yb) = self._read(location, level, size)
        out = np.zeros(rgb.shape[:2] + (4,), dtype=np.uint8)
        out[..., :3] = rgb
        out[ya:yb, xa:xb, 3] = 255
        return out

    def read_rgb(self, location, size) -> np.ndarray:
        """``read_region(location, 0, size)``'s colours without its alpha (black
        past the edge): the patch readers' path, which spares them two
        copies of the patch through the RGBA layout."""
        return self._read(location, 0, size)[0]

    def get_thumbnail(self, size) -> np.ndarray:
        """OpenSlide's ``get_thumbnail``: the best level for the size, read
        whole, on white where transparent; then, where it does not fit in
        ``size``, the bicubic resize to PIL's thumbnail size. At a level's
        own dimensions (as the tiling and the heatmaps ask) that is the
        level's read, not resampled."""
        downsample = max(d / t for d, t in zip(self.dimensions, size))
        level = self.get_best_level_for_downsample(downsample)
        rgba = self.read_region((0, 0), level, self.level_dimensions[level])
        rgb = np.where(rgba[..., 3:] == 0, np.uint8(255), rgba[..., :3])
        target = _thumbnail_size(rgb.shape[1], rgb.shape[0], size)
        return rgb if target is None else resize_u8(rgb, target)

    def close(self) -> None:
        if self._jpeg is not None and hasattr(self._jpeg, "close"):
            self._jpeg.close()
        self._file.close()


def open_slide(filepath, device="cpu"):
    """A slide reader for ``filepath``, in this order: OpenSlide where it
    imports; :class:`TiffSlide` for ``.tif``/``.tiff``/``.svs`` (JPEG tiles
    decoded on ``device``); :class:`ImageSlide` over :func:`read_png` for
    ``.png``; else :class:`ImageSlide` through PIL."""
    filepath = str(filepath)
    if _openslide is not None:
        try:
            return _openslide.open_slide(filepath)
        except Exception:  # a file OpenSlide does not take: the port's readers try it
            pass
    if filepath.lower().endswith(TIFF_SUFFIXES):
        return TiffSlide(filepath, device=device)
    return ImageSlide(filepath)


def get_three_points(x_step: int, y_step: int, size) -> tuple:
    """Grid cell -> (top_left, bottom_right, center) pixel coordinates."""
    top_left = (int(x_step * size), int(y_step * size))
    bottom_right = (int(top_left[0] + size), int(top_left[1] + size))
    center = ((top_left[0] + bottom_right[0]) // 2, (top_left[1] + bottom_right[1]) // 2)
    return top_left, bottom_right, center


def read_patch(slide, location, size) -> np.ndarray:
    """A level-0 region as ``(h, w, 3)`` RGB uint8: ``read_rgb`` where the
    slide has it (:class:`TiffSlide`), else ``read_region``'s colours."""
    read_rgb = getattr(slide, "read_rgb", None)
    if read_rgb is not None:
        return read_rgb(location, size)
    return as_rgb(slide.read_region(location, 0, size))


def as_rgb(image) -> np.ndarray:
    """An OpenSlide (PIL) image or a port array (RGB or RGBA) as an RGB uint8
    array."""
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))
    return np.asarray(image)[..., :3]


def downsample_image(slide, downsampling_factor: float = 16):
    """``(RGB array, level)``: the best pyramid level for the factor, read as
    RGBA and resized to ``dims // downsampling_factor`` with
    :func:`resize_u8` (reference ``wsi_processing/utils.py:12-26``), which
    premultiplies RGBA as PIL's resize of the JAX package does. A slide
    opened for the card that is opaque there (premultiplying is then the
    identity) is resized on the card, to the same pixels."""
    level = slide.get_best_level_for_downsample(downsampling_factor + 0.1)
    rgba = np.asarray(slide.read_region((0, 0), level, slide.level_dimensions[level]))
    target = tuple(int(x // downsampling_factor) for x in slide.dimensions)
    device = str(getattr(slide, "device", "cpu"))
    if device != "cpu" and rgba.shape[1::-1] != target and (rgba[..., 3] == 255).all():
        import torch

        from murcl_tpu_torch.preprocess.resample import resize_u8_torch

        rgb = torch.from_numpy(rgba[..., :3]).to(device)[None]
        return resize_u8_torch(rgb, target)[0].cpu().numpy(), level
    return np.ascontiguousarray(resize_u8(rgba, target)[..., :3]), level


def keep_patch(mask_patch: np.ndarray, thresh: float, bg_color: np.ndarray) -> bool:
    """True when the mask tile's background proportion is <= 1 - thresh."""
    bg = np.all(mask_patch == bg_color, axis=2)
    return (bg.sum() / bg.size) <= (1 - thresh)


def out_of_bound(w: int, h: int, x: int, y: int) -> bool:
    return x >= w or y >= h
