"""Tissue-mask filters for WSI tiling (counterpart of
``murcl_tpu/preprocess/filters.py``; reference ``wsi_processing/filters.py``).

Three mask algorithms, each returning ``(mask, bg_color)`` with the mask an
``(h, w)`` uint8 array, 255 = background (the JAX package returns the same
pixels as a PIL image):

- ``otsu``: grayscale -> 5x5 Gaussian blur -> Otsu threshold;
- ``adaptive``: Gaussian adaptive threshold, block 11, C = 2;
- ``rgb`` (default): green-channel, gray and red/green/blue pen filters,
  then small-object removal (4-connectivity, skimage's default).

The OpenCV calls are :mod:`murcl_tpu_torch.preprocess.cvcompat`'s numpy
equivalents and the mask files go through
:func:`murcl_tpu_torch.utils.png.write_png`, so no filter needs ``cv2``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from murcl_tpu_torch.preprocess import cvcompat
from murcl_tpu_torch.preprocess.slide_io import downsample_image
from murcl_tpu_torch.utils.png import write_png

WHITE_BG = np.array([255, 255, 255])

# (red_lower, green_upper, blue_upper): pen pixel if r>rl & g<gu & b<bu
RED_PEN_BANDS = [
    (150, 80, 90), (110, 20, 30), (185, 65, 105), (195, 85, 125),
    (220, 115, 145), (125, 40, 70), (200, 120, 150), (100, 50, 65),
    (85, 25, 45),
]
# (red_upper, green_lower, blue_lower): pen pixel if r<ru & g>gl & b>bl
GREEN_PEN_BANDS = [
    (150, 160, 140), (70, 110, 110), (45, 115, 100), (30, 75, 60),
    (195, 220, 210), (225, 230, 225), (170, 210, 200), (20, 30, 20),
    (50, 60, 40), (30, 50, 35), (65, 70, 60), (100, 110, 105),
    (165, 180, 180), (140, 140, 150), (185, 195, 195),
]
# (red_upper, green_upper, blue_lower): pen pixel if r<ru & g<gu & b>bl
BLUE_PEN_BANDS = [
    (60, 120, 190), (120, 170, 200), (175, 210, 230), (145, 180, 210),
    (37, 95, 160), (30, 65, 130), (130, 155, 180), (40, 35, 85),
    (30, 20, 65), (90, 90, 140), (60, 60, 120), (110, 110, 175),
]


def _as_type(mask: np.ndarray, output_type: str):
    if output_type == "bool":
        return mask
    if output_type == "float":
        return mask.astype(float)
    return mask.astype("uint8") * 255


def mask_percent(np_img: np.ndarray) -> float:
    """Percentage of masked-out (zero) pixels (``filters.py:71-78``)."""
    if np_img.ndim == 3 and np_img.shape[2] == 3:
        np_img = np_img[:, :, 0] + np_img[:, :, 1] + np_img[:, :, 2]
    return 100.0 - np.count_nonzero(np_img) / np_img.size * 100.0


def tissue_percent(np_img: np.ndarray) -> float:
    return 100.0 - mask_percent(np_img)


def saturation(img: np.ndarray, t: float = 15) -> bool:
    """Mean-saturation test (``filters.py:61-68``; skimage-HSV semantics)."""
    rgb = img.astype(np.float64) / 255.0
    mx = rgb.max(axis=2)
    mn = rgb.min(axis=2)
    sat = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-12), 0.0)
    sat_u8 = (sat * 255 + 0.5).astype(np.uint8)  # img_as_ubyte rounding
    return (sat_u8.sum() / sat.size) >= t


def filter_green_channel(rgb, green_thresh=200, avoid_overmask=True,
                         overmask_thresh=90, output_type="bool"):
    """Keep pixels whose green channel is in (0, thresh); relax the threshold
    when the mask would remove >= overmask_thresh% (``filters.py:84-101``)."""
    g = rgb[:, :, 1]
    mask = (g < green_thresh) & (g > 0)
    if avoid_overmask and mask_percent(mask) >= overmask_thresh and green_thresh < 255:
        relaxed = math.ceil((255 - green_thresh) / 2 + green_thresh)
        return filter_green_channel(rgb, relaxed, avoid_overmask, overmask_thresh, output_type)
    return _as_type(mask, output_type)


def filter_grays(rgb, tolerance=15, output_type="bool"):
    """Drop near-gray pixels: all pairwise channel diffs <= tolerance."""
    c = rgb.astype(np.int64)
    gray = (
        (np.abs(c[:, :, 0] - c[:, :, 1]) <= tolerance)
        & (np.abs(c[:, :, 0] - c[:, :, 2]) <= tolerance)
        & (np.abs(c[:, :, 1] - c[:, :, 2]) <= tolerance)
    )
    return _as_type(~gray, output_type)


def _pen_mask(rgb, bands, kind: str) -> np.ndarray:
    """True where the pixel survives every pen band of one color."""
    r = rgb[:, :, 0].astype(np.int64)
    g = rgb[:, :, 1].astype(np.int64)
    b = rgb[:, :, 2].astype(np.int64)
    keep = np.ones(rgb.shape[:2], dtype=bool)
    for t0, t1, t2 in bands:
        if kind == "red":
            pen = (r > t0) & (g < t1) & (b < t2)
        elif kind == "green":
            pen = (r < t0) & (g > t1) & (b > t2)
        else:  # blue
            pen = (r < t0) & (g < t1) & (b > t2)
        keep &= ~pen
    return keep


def filter_red_pen(rgb, output_type="bool"):
    return _as_type(_pen_mask(rgb, RED_PEN_BANDS, "red"), output_type)


def filter_green_pen(rgb, output_type="bool"):
    return _as_type(_pen_mask(rgb, GREEN_PEN_BANDS, "green"), output_type)


def filter_blue_pen(rgb, output_type="bool"):
    return _as_type(_pen_mask(rgb, BLUE_PEN_BANDS, "blue"), output_type)


def filter_remove_small_objects(np_img, min_size=500, avoid_overmask=True,
                                overmask_thresh=95, output_type="uint8"):
    """Drop 4-connected components smaller than ``min_size`` pixels, halving
    ``min_size`` while the result would mask >= overmask_thresh%
    (``filters.py:228-244``)."""
    labels, areas = cvcompat.component_areas(np_img.astype(bool))
    keep = areas >= min_size  # skimage: objects strictly smaller are removed
    keep[0] = False
    out = keep[labels]
    if avoid_overmask and mask_percent(out) >= overmask_thresh and min_size >= 1:
        return filter_remove_small_objects(
            np_img, min_size / 2, avoid_overmask, overmask_thresh, output_type
        )
    return _as_type(out, output_type)


def mask_rgb(rgb, mask):
    return rgb * np.dstack([mask, mask, mask])


# ---------------------------------------------------------------------------
# Top-level mask algorithms
# ---------------------------------------------------------------------------
def otsu(slide, mask_downsample, mask_filepath: Optional[str] = None
         ) -> Tuple[np.ndarray, np.ndarray]:
    img, _ = downsample_image(slide, mask_downsample)
    gray = cvcompat.gaussian_blur5(cvcompat.bgr_to_gray(img[:, :, ::-1]))
    _, th = cvcompat.otsu_threshold(gray)
    if mask_filepath is not None:
        write_png(mask_filepath, th)
    return th, WHITE_BG.copy()


def adaptive(slide, mask_downsample, mask_filepath: Optional[str] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    img, _ = downsample_image(slide, mask_downsample)
    th = cvcompat.adaptive_threshold(cvcompat.bgr_to_gray(img[:, :, ::-1]))
    if mask_filepath is not None:
        write_png(mask_filepath, th)
    return th, WHITE_BG.copy()


def RGB_filter(slide, mask_downsample, mask_filepath: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Composite tissue mask with pen-mark removal (``filters.py:252-275``):
    tissue pixels 0, background 255. The mask file holds the masked slide
    with red and blue swapped, as the JAX package hands ``cv2.imwrite`` an
    RGB array (``murcl_tpu/preprocess/filters.py:203``)."""
    img, _ = downsample_image(slide, mask_downsample)
    tissue = (
        filter_grays(img)
        & filter_green_channel(img)
        & filter_red_pen(img)
        & filter_green_pen(img)
        & filter_blue_pen(img)
    )
    tissue = filter_remove_small_objects(tissue, min_size=500, output_type="bool")
    if mask_filepath is not None:
        write_png(mask_filepath, mask_rgb(img, tissue))
    return np.uint8(255 * ~tissue), WHITE_BG.copy()


MASK_ALGORITHMS = {"otsu": otsu, "adaptive": adaptive, "rgb": RGB_filter}
