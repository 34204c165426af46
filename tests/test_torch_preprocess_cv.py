"""The port's replacements for OpenCV and PIL against the libraries themselves.

- ``cvcompat``: grayscale, the 5x5 Gaussian blur, Otsu's threshold, the
  Gaussian adaptive threshold, 4-connected component areas and the
  thickness-3 rectangle equal ``cv2`` bit for bit on random uint8 images
  (odd sizes, down to 1 x 7) and on the blob slide of
  ``tests/test_preprocess.py``. The thick closed polyline equals
  ``cv2.drawContours`` at thickness 5 bit for bit over 40 random polygons,
  slanted polygons reaching past the image, and a square.
- ``resize_u8`` against ``PIL.Image.resize`` (bicubic): bit for bit, down
  and up, at odd sizes, in RGB and in RGBA (premultiplied, as PIL does).
- ``resize_u8_torch`` (the card's float64 resize) against the same, on a
  batch of RGB images.
- ``write_png``: grayscale and BGR files read back by ``cv2.imread``
  unchanged.
"""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from murcl_tpu_torch.preprocess import cvcompat
from murcl_tpu_torch.preprocess.resample import resize_u8, resize_u8_torch
from murcl_tpu_torch.utils.png import write_png

SHAPES = [(1, 7), (2, 2), (3, 9), (37, 53), (192, 256), (401, 333)]


def blob_slide():
    """``tests/test_preprocess.py:15-34``'s 2048 x 1536 slide as RGB."""
    rng = np.random.default_rng(0)
    img = np.full((1536, 2048, 3), 255, dtype=np.uint8)
    yy, xx = np.mgrid[0:1536, 0:2048]
    blob = ((yy - 700) / 450) ** 2 + ((xx - 900) / 600) ** 2 < 1.0
    img[blob] = np.stack([rng.integers(180, 230, blob.sum()),
                          rng.integers(120, 170, blob.sum()),
                          rng.integers(160, 210, blob.sum())], axis=1).astype(np.uint8)
    img[100:140, 200:1800] = np.array([230, 30, 40], dtype=np.uint8)
    img[1300:1340, 100:1000] = np.array([40, 50, 220], dtype=np.uint8)
    return img


def _images():
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in SHAPES]
    out.append(np.ascontiguousarray(blob_slide()[::8, ::8, ::-1]))  # BGR
    return out


def test_gray_and_blur_equal_cv2():
    for bgr in _images():
        gray = cvcompat.bgr_to_gray(bgr)
        np.testing.assert_array_equal(gray, cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
        np.testing.assert_array_equal(cvcompat.gaussian_blur5(gray),
                                      cv2.GaussianBlur(gray, (5, 5), 0))


def test_thresholds_equal_cv2():
    for bgr in _images():
        gray = cv2.GaussianBlur(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY), (5, 5), 0)
        level, th = cvcompat.otsu_threshold(gray)
        want_level, want = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert level == want_level
        np.testing.assert_array_equal(th, want)
        np.testing.assert_array_equal(
            cvcompat.adaptive_threshold(gray),
            cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                  cv2.THRESH_BINARY, 11, 2))


def test_component_areas_equal_cv2():
    rng = np.random.default_rng(3)
    for shape in SHAPES[2:]:
        mask = rng.random(shape) < 0.45
        labels, areas = cvcompat.component_areas(mask)
        n, want_labels, stats, _ = cv2.connectedComponentsWithStats(
            mask.astype(np.uint8), connectivity=4)
        assert len(areas) == n
        # the same partition: each component's area at each of its pixels
        np.testing.assert_array_equal(areas[labels][mask],
                                      stats[want_labels, cv2.CC_STAT_AREA][mask])
        assert (labels[~mask] == 0).all()


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
def test_rectangle_equals_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(40):
        h, w = rng.integers(20, 80, 2)
        x0, x1 = sorted(int(v) for v in rng.integers(-5, w + 5, 2))
        y0, y1 = sorted(int(v) for v in rng.integers(-5, h + 5, 2))
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.rectangle(want, (x0, y0), (x1, y1), (0, 0, 255), thickness=thickness)
        cvcompat.rectangle(got, (x0, y0), (x1, y1), (0, 0, 255), thickness)
        np.testing.assert_array_equal(got, want)


def test_polylines_against_cv2_draw_contours():
    rng = np.random.default_rng(0)
    for i in range(80):
        want = np.zeros((200, 300, 3), np.uint8)
        got = want.copy()
        n = rng.integers(3, 30)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        if i < 40:  # inside the image
            rad, centre = rng.uniform(20, 90, n), (150, 100)
        else:  # slanted, reaching past the image's edges
            rad, centre = rng.uniform(5, 220, n), (rng.uniform(0, 300), rng.uniform(0, 200))
        pts = np.stack([centre[0] + rad * np.cos(ang), centre[1] + rad * np.sin(ang)],
                       1).astype(np.int32)
        cv2.drawContours(want, [pts[:, None, :]], -1, (0, 255, 255), thickness=5)
        cvcompat.polylines(got, pts, (0, 255, 255), 5)
        np.testing.assert_array_equal(got, want)
    square = np.array([[20, 20], [120, 20], [120, 90], [20, 90]], np.int32)
    want = np.zeros((110, 150, 3), np.uint8)
    got = want.copy()
    cv2.drawContours(want, [square[:, None, :]], -1, (0, 255, 255), thickness=5)
    cvcompat.polylines(got, square, (0, 255, 255), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src, dst", [((512, 512), (256, 256)), ((1000, 700), (62, 43)),
                                      ((300, 300), (18, 18)), ((2048, 1536), (64, 48)),
                                      ((37, 53), (100, 9)), ((7, 1), (3, 5))])
def test_resize_u8_within_one_of_pil(src, dst):
    """Bit for bit with PIL now (the name is kept from the bounded version)."""
    rng = np.random.default_rng(src[0])
    img = (blob_slide() if src == (2048, 1536)
           else rng.integers(0, 256, (src[1], src[0], 3), dtype=np.uint8))
    want = np.asarray(Image.fromarray(img).resize(dst))
    got = resize_u8(img, dst)
    assert got.shape == (dst[1], dst[0], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], dtype=np.uint8)])
    np.testing.assert_array_equal(resize_u8(rgba, dst),
                                  np.asarray(Image.fromarray(rgba, "RGBA").resize(dst)))
    np.testing.assert_array_equal(resize_u8(img, src), img)


@pytest.mark.parametrize("src, dst", [((512, 512), (256, 256)), ((1000, 700), (62, 43)),
                                      ((37, 53), (100, 9)), ((7, 1), (3, 5)), ((64, 48), (64, 20))])
def test_resize_u8_torch_equals_pil(src, dst):
    """The float64 resize of the card's extraction and downsample, run here on
    the CPU: bit for bit with PIL, over a batch."""
    rng = np.random.default_rng(src[0] + 1)
    imgs = rng.integers(0, 256, (3, src[1], src[0], 3), dtype=np.uint8)
    got = resize_u8_torch(torch.from_numpy(imgs), dst)
    assert got.shape == (3, dst[1], dst[0], 3) and got.dtype == torch.uint8
    for img, one in zip(imgs, got.numpy()):
        np.testing.assert_array_equal(one, np.asarray(Image.fromarray(img).resize(dst)))


def test_png_grayscale_and_bgr_read_back(tmp_path):
    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    write_png(tmp_path / "g.png", gray)
    back = cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED)
    assert back.shape == gray.shape
    np.testing.assert_array_equal(back, gray)
    bgr = rng.integers(0, 256, (21, 5, 3), dtype=np.uint8)
    write_png(tmp_path / "c.png", bgr)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_UNCHANGED), bgr)
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", bgr.astype(np.float32))
