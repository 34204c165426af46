"""The OpenCV operations the tissue filters, the tiling overview and the
heatmaps' ROI outline use, in numpy and scipy, so that none of them needs
``cv2`` (the GPU machine has none).

Each equals the OpenCV 5.0 call beside it on uint8 images, bit for bit, as
``tests/test_torch_preprocess_cv.py`` holds against ``cv2`` itself; the
one exception is :func:`polylines`, whose slanted segments are rasterised
by pixel centre and differ from OpenCV's fixed-point polygon fill in a
stated share of the outline's pixels (same file).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2GRAY)``: OpenCV's 15-bit fixed point."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def gaussian_blur5(gray: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(gray, (5, 5), 0)`` on uint8: OpenCV's bit-exact path,
    the kernel [1 4 6 4 1] / 16 each way, ``BORDER_REFLECT_101``, the sum
    rounded half up once."""
    w = (1, 4, 6, 4, 1)
    h, wd = gray.shape
    p = np.pad(gray.astype(np.int32), 2, mode="reflect")
    rows = sum(k * p[:, i:i + wd] for i, k in enumerate(w))
    return ((sum(k * rows[i:i + h] for i, k in enumerate(w)) + 128) >> 8).astype(np.uint8)


def otsu_threshold(gray: np.ndarray) -> Tuple[int, np.ndarray]:
    """``cv2.threshold(gray, 0, 255, THRESH_BINARY + THRESH_OTSU)``: the level
    of largest between-class variance over the histogram, in OpenCV's order
    of double sums (a later level wins only if strictly larger), then
    ``gray > level`` as 255."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    eps = float(np.finfo(np.float32).eps)
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    level = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, level = sigma, i
    return level, np.where(gray > level, 255, 0).astype(np.uint8)


def _gaussian_kernel(n: int) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0)`` as f32: sigma 0.3 ((n - 1) / 2 - 1) + 0.8."""
    sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def adaptive_threshold(gray: np.ndarray) -> np.ndarray:
    """``cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY, 11, 2)``: an f32 Gaussian mean of the 11 x 11 block
    (``BORDER_REPLICATE``; symmetric taps summed in pairs, as OpenCV's
    separable filter does), rounded half to even to uint8, then
    ``gray > mean - 2`` as 255."""
    k = _gaussian_kernel(11)
    r = 5
    h, w = gray.shape
    p = np.pad(gray.astype(np.float32), r, mode="edge")
    rows = k[r] * p[:, r:r + w]
    for i in range(1, r + 1):
        rows = rows + k[r + i] * (p[:, r - i:r - i + w] + p[:, r + i:r + i + w])
    mean = k[r] * rows[r:r + h]
    for i in range(1, r + 1):
        mean = mean + k[r + i] * (rows[r - i:r - i + h] + rows[r + i:r + i + h])
    mean = np.rint(mean).clip(0, 255).astype(np.int32)
    return np.where(gray.astype(np.int32) > mean - 2, 255, 0).astype(np.uint8)


def component_areas(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.connectedComponentsWithStats(mask, connectivity=4)``'s labels and
    areas (``CC_STAT_AREA``), label 0 the background; the components are
    numbered in another order than OpenCV's, with the same pixels."""
    labels, n = ndimage.label(mask, structure=ndimage.generate_binary_structure(2, 1))
    return labels, np.bincount(labels.ravel(), minlength=n + 1)


def _fill(img: np.ndarray, covered: np.ndarray, y0: int, x0: int, color) -> None:
    h, w = covered.shape
    ya, xa = max(y0, 0), max(x0, 0)
    yb, xb = min(y0 + h, img.shape[0]), min(x0 + w, img.shape[1])
    if ya < yb and xa < xb:
        region = img[ya:yb, xa:xb]
        region[covered[ya - y0:yb - y0, xa - x0:xb - x0]] = color


def _scan_quad(img: np.ndarray, quad: np.ndarray, color) -> None:
    """Fill a convex quad ((4, 2) float x, y) row by row, each row from
    round(left) to round(right) as OpenCV's ``FillConvexPoly`` does, then
    trace its edges as 8-connected lines through rounded points."""
    ys = quad[:, 1]
    edges = list(zip(quad, np.roll(quad, -1, axis=0)))
    for y in range(int(np.floor(ys.min() + 0.5)), int(np.floor(ys.max() + 0.5)) + 1):
        if not 0 <= y < img.shape[0]:
            continue
        yc = min(max(y, ys.min()), ys.max())
        xs = []
        for (xa, ya), (xb, yb) in edges:
            if min(ya, yb) <= yc <= max(ya, yb):
                xs += [xa, xb] if ya == yb else [xa + (yc - ya) * (xb - xa) / (yb - ya)]
        xl = max(int(np.floor(min(xs) + 0.5)), 0)
        xr = min(int(np.floor(max(xs) + 0.5)), img.shape[1] - 1)
        img[y, xl:xr + 1] = color
    for a, b in edges:
        major = 0 if abs(b[0] - a[0]) >= abs(b[1] - a[1]) else 1
        if a[major] > b[major]:
            a, b = b, a
        steps = np.arange(np.floor(a[major] + 0.5), np.floor(b[major] + 0.5) + 1)
        span = b[major] - a[major]
        minor = a[1 - major] + ((steps - a[major]) * (b[1 - major] - a[1 - major]) / span
                                if span else 0.0)
        pix = np.stack([steps, np.floor(minor + 0.5)] if major == 0
                       else [np.floor(minor + 0.5), steps], axis=1).astype(np.int64)
        ok = ((pix[:, 0] >= 0) & (pix[:, 0] < img.shape[1])
              & (pix[:, 1] >= 0) & (pix[:, 1] < img.shape[0]))
        img[pix[ok, 1], pix[ok, 0]] = color


def polylines(img: np.ndarray, points: Sequence, color, thickness: int) -> None:
    """A closed polyline of integer ``points`` ((N, 2) x, y) drawn in place as
    OpenCV draws one thicker than 1 (``LINE_8``): each segment a quad
    widened by ``thickness / 2`` on either side (half a pixel more when it
    is odd, rounded to 1/65536 px), and a disc of radius
    ``(thickness + 1) // 2`` on every vertex. Axis-parallel segments equal
    OpenCV's; on slanted ones OpenCV steps its fixed-point edges
    incrementally, so a few edge pixels differ."""
    pts = np.asarray(points, dtype=np.int64).reshape(-1, 2)
    half = (thickness + (thickness & 1)) / 2.0
    radius = (thickness + 1) // 2
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = dx * dx + dy * dy <= radius * radius
    for (x0, y0), (x1, y1) in zip(np.roll(pts, 1, axis=0), pts):
        length = float(np.hypot(x1 - x0, y1 - y0))
        if length > 0:
            ox = np.round((y1 - y0) * half / length * 65536) / 65536
            oy = np.round((x0 - x1) * half / length * 65536) / 65536
            _scan_quad(img, np.array([[x0 + ox, y0 + oy], [x0 - ox, y0 - oy],
                                      [x1 - ox, y1 - oy], [x1 + ox, y1 + oy]]), color)
        _fill(img, disc, y1 - radius, x1 - radius, color)


def rectangle(img: np.ndarray, top_left, bottom_right, color, thickness: int) -> None:
    """``cv2.rectangle(img, top_left, bottom_right, color, thickness)`` for a
    thickness above 1, in place: each side a band ``thickness / 2`` wide on
    either side of it (half a pixel more when odd), a disc on each corner."""
    (x0, y0), (x1, y1) = top_left, bottom_right
    half = (thickness + (thickness & 1)) // 2
    radius = (thickness + 1) // 2
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = dx * dx + dy * dy <= radius * radius
    for y in (y0, y1):
        _fill(img, np.ones((2 * half + 1, x1 - x0 + 1), bool), y - half, x0, color)
    for x in (x0, x1):
        _fill(img, np.ones((y1 - y0 + 1, 2 * half + 1), bool), y0, x - half, color)
    for x, y in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)):
        _fill(img, disc, y - radius, x - radius, color)
