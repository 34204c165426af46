"""The OpenCV operations the tissue filters, the tiling overview and the
heatmaps' ROI outline use, in numpy and scipy, so that none of them needs
``cv2`` (the GPU machine has none).

Each equals the OpenCV 5.0 call beside it on uint8 images, bit for bit, as
``tests/test_torch_preprocess_cv.py`` holds against ``cv2`` itself;
:func:`polylines` reproduces OpenCV's 16-bit fixed-point drawing
(``ThickLine``, ``FillConvexPoly``, ``Line2``, ``Circle``, ``clipLine``)
step by step.
"""

from __future__ import annotations

import math
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


# OpenCV's drawing.cpp works in fixed point with 16 fractional bits
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` to ``[0, w) x [0, h)``: the clipped ends, or None when
    the line misses the rectangle."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """``Line2``: an 8-connected line between fixed-point ends, clipped to the
    image, stepping the minor axis by ``(d << 16) / (major | 1)``."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    horizontal = abs(dx) > abs(dy)
    if horizontal:
        if dx < 0:
            dy, x1, x2, y1, y2 = -dy, x2, x1, y2, y1
        step = _tdiv(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx, x1, x2, y1, y2 = -dx, x2, x1, y2, y1
        step = _tdiv(dx << XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, color)
    x1, y1 = x1 + half, y1 + half
    if horizontal:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1, y1 = x1 + 1, y1 + step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1, y1 = x1 + step, y1 + 1


def _fill_convex_poly(img: np.ndarray, v: list, color) -> None:
    """``FillConvexPoly`` at ``shift = XY_SHIFT``, ``LINE_8``: the outline by
    :func:`_line2`, then rows between two edges walked down from the top
    vertex, each edge's x stepped by a fixed-point increment from its
    start vertex (not re-anchored per row: OpenCV's own rasterisation)."""
    npts, delta = len(v), XY_ONE >> 1
    h, w = img.shape[:2]
    p0 = v[-1]
    imin = min(range(npts), key=lambda i: (v[i][1], i))
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx, ye, di = [imin, imin], [ymin, ymin], [1, npts - 1]
    ex, edx = [-XY_ONE, -XY_ONE], [0, 0]
    y, edges = ymin, npts
    while True:
        for i in range(2):
            if y < ye[i]:
                continue
            i0 = idx[i]
            i1 = (i0 + di[i]) % npts
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[i1][1] + delta) >> XY_SHIFT
                if ty > y:
                    ye[i], ex[i], idx[i] = ty, v[i0][0], i1
                    edx[i] = _tdiv((v[i1][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y))
                    break
                i0, i1 = i1, (i1 + di[i]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            x1, x2 = (ex[left] + delta) >> XY_SHIFT, (ex[right] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle``: the midpoint circle's spans, clipped."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """``ThickLine`` with ``flags = 2`` (a cap at the end only): the quad
    ``p0 ± dp, p1 ± dp`` with ``dp`` the normal of length ``thickness / 2``
    (half a pixel more when odd) rounded to 1/65536 px, then a filled
    circle of radius ``(thickness + 1) // 2`` at ``p1``."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:  # DBL_EPSILON
        r = (thick + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)  # cvRound: half to even
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], color)
    half = XY_ONE >> 1
    _circle_filled(img, (p1[0] + half) >> XY_SHIFT, (p1[1] + half) >> XY_SHIFT,
                   (thick + half) >> XY_SHIFT, color)


def polylines(img: np.ndarray, points: Sequence, color, thickness: int) -> None:
    """``cv2.drawContours(img, [points], -1, color, thickness)`` for one
    closed contour of integer ``points`` ((N, 2) x, y) and a thickness
    above 1, in place, as OpenCV 5.0 draws it: each segment from the
    previous point, clipped to the image widened by ``thickness`` on every
    side, is a ``ThickLine`` in 16-bit fixed point (a quad filled by
    ``FillConvexPoly``'s incremental edge stepping, and a disc at its end)."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    prev = pts[-1]
    for cur in pts:
        t = thickness
        clipped = _clip_line(w + 2 * t, h + 2 * t, prev[0] + t, prev[1] + t, cur[0] + t,
                             cur[1] + t)
        if clipped is not None:
            _thick_line(img, (clipped[0] - t, clipped[1] - t), (clipped[2] - t, clipped[3] - t),
                        color, thickness)
        prev = cur


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
