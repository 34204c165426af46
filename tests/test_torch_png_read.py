"""``read_png`` against ``cv2.imread`` and PIL.

- PNGs whose rows use each of the five filters (None, Sub, Up, Average,
  Paeth; one filter for all rows, or a different one per row), in gray,
  RGB and RGBA, written here by a numpy filter encoder, read equal to
  ``cv2.imread`` (colour reversed: OpenCV returns BGR) and to the source.
- Files written by ``cv2.imwrite`` and PIL (their own filter choices) and
  by the port's ``write_png`` read back unchanged.
- A ``.png`` slide opens without PIL (blocked in a subprocess) and reads
  as the JAX package's ``ImageSlide`` of the same file (JAX's test slides
  are PNGs, ``tests/test_preprocess.py:185-186``).
"""

import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from murcl_tpu_torch.utils.png import read_png, write_png

REPO = Path(__file__).resolve().parents[1]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(img: np.ndarray, kinds) -> bytes:
    """Rows filtered with ``kinds[y]`` (0-4), as a PNG encoder writes them."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, ul)}[kinds[y]]
        out.append(bytes([kinds[y]]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _write_filtered(path, img, kinds):
    colour = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    h, w = img.shape[:2]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    data = zlib.compress(_filtered(img, kinds), 6)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                           + chunk(b"IDAT", data[:len(data) // 2])  # two IDAT chunks
                           + chunk(b"IDAT", data[len(data) // 2:]) + chunk(b"IEND", b""))


def _cv2_as_rgb(path):
    got = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if got.ndim == 3:
        got = got[..., [2, 1, 0, 3][:got.shape[2]]]
    return got


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_each_filter_equals_cv2(tmp_path, channels, kind):
    rng = np.random.default_rng(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[5:9] = 200  # flat rows
    kinds = [y % 5 for y in range(23)] if kind == "mixed" else [kind] * 23
    path = tmp_path / "f.png"
    _write_filtered(path, img, kinds)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _cv2_as_rgb(path))


@pytest.mark.parametrize("writer", ["cv2", "pil", "port"])
def test_other_writers_read_back(tmp_path, writer):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 97, 3), dtype=np.uint8)
    img[:, 40:60] = (10, 200, 30)
    path = tmp_path / "w.png"
    if writer == "cv2":
        cv2.imwrite(str(path), img[..., ::-1])
    elif writer == "pil":
        Image.fromarray(img).save(path)
    else:
        write_png(path, img[..., ::-1])  # BGR in, as cv2.imwrite takes it
        write_png(tmp_path / "g.png", img[..., 0])
        np.testing.assert_array_equal(read_png(tmp_path / "g.png"), img[..., 0])
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_png(path), _cv2_as_rgb(path))


def test_png_slide_without_pil_equals_jax(tmp_path):
    from murcl_tpu.preprocess.slide_io import ImageSlide as JaxImageSlide

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)
    path = tmp_path / "slide.png"
    Image.fromarray(img).save(path)
    jax_slide = JaxImageSlide(path)
    want = np.asarray(jax_slide.read_region((64, 128), 0, (128, 96)))
    np.save(tmp_path / "want.npy", want)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None  # blocked
        import numpy as np
        from murcl_tpu_torch.preprocess.slide_io import open_slide
        s = open_slide({str(path)!r})
        got = s.read_region((64, 128), 0, (128, 96))
        assert np.array_equal(got, np.load({str(tmp_path / "want.npy")!r})), "differs"
        assert s.dimensions == (256, 256)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(tmp_path / "p.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")
