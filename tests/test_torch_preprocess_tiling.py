"""The port's tissue filters and tiling against the JAX package's.

The blob slide of ``tests/test_preprocess.py:15-35`` (2048 x 1536, a
textured pink blob, red and blue pen strokes), once as the JAX package's
PIL ``ImageSlide`` and once as the port's numpy one:

- every filter helper equals JAX's on the downsampled slide and on random
  images, bit for bit; ``otsu``, ``adaptive`` and ``RGB_filter`` give the
  same masks and write the same mask files (read back by ``cv2.imread``;
  ``RGB_filter``'s file is the masked downsampled slide, equal too now
  that the resize is PIL's own);
- ``tiling`` writes the same coord json, overview, mask and patch PNGs in
  all three methods;
- ``run_tiling`` skips an existing coord json and names files by
  ``--specify_filename``;
- the heatmaps' ROI outline (``--draw_contours``) equals JAX's
  ``cv2.drawContours`` one;
- tiling a TIFF *file* (a pyramid of levels 1, 4 and 16 read through
  ``open_slide``, and a single-level file) writes the same coord json,
  overview and mask as the JAX package's tiling of the same pixels (the
  same pyramid handed to it as PIL images, and its ``ImageSlide``).
"""

import importlib
from argparse import Namespace

import cv2
import numpy as np
import pytest
from PIL import Image

import murcl_tpu.preprocess.filters as jf
import murcl_tpu.preprocess.heatmaps as jax_hm
from murcl_tpu.preprocess.slide_io import ImageSlide as JaxImageSlide
from murcl_tpu.preprocess.slide_io import downsample_image as jax_downsample
from murcl_tpu_torch.preprocess import filters as tf
from murcl_tpu_torch.preprocess import heatmaps as hm
from murcl_tpu_torch.preprocess import tiling as tt
from murcl_tpu_torch.preprocess.slide_io import ImageSlide, downsample_image, keep_patch
from test_torch_preprocess_cv import blob_slide

jt = importlib.import_module("murcl_tpu.preprocess.tiling")
PROPS = {"aperio.AppMag": "20"}


@pytest.fixture(scope="module")
def slides():
    img = blob_slide()
    return (JaxImageSlide("fake.png", image=Image.fromarray(img), properties=dict(PROPS)),
            ImageSlide("fake.png", image=img, properties=dict(PROPS)))


def test_downsample_image_equals_jax(slides):
    for f in (8, 16, 32):
        want, wl = jax_downsample(slides[0], f)
        got, gl = downsample_image(slides[1], f)
        assert gl == wl and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_filter_helpers_equal_jax(slides):
    rng = np.random.default_rng(4)
    imgs = [jax_downsample(slides[0], 8)[0], rng.integers(0, 256, (33, 47, 3), dtype=np.uint8),
            np.zeros((10, 10, 3), np.uint8), np.full((9, 11, 3), 128, np.uint8)]
    for img in imgs:
        for name in ("filter_grays", "filter_green_channel", "filter_red_pen",
                     "filter_green_pen", "filter_blue_pen"):
            for out in ("bool", "float", "uint8"):
                np.testing.assert_array_equal(getattr(tf, name)(img, output_type=out),
                                              getattr(jf, name)(img, output_type=out))
        assert tf.saturation(img) == jf.saturation(img)
        assert tf.mask_percent(img) == jf.mask_percent(img)
        assert tf.tissue_percent(img) == jf.tissue_percent(img)
        tissue = jf.filter_grays(img) & jf.filter_green_channel(img)
        for min_size in (500, 30, 3):
            np.testing.assert_array_equal(
                tf.filter_remove_small_objects(tissue, min_size=min_size),
                jf.filter_remove_small_objects(tissue, min_size=min_size))
    bg = np.array([255, 255, 255])
    tile = np.full((8, 8, 3), 255, np.uint8)
    tile[:3] = 100
    for t in (0.3, 0.35, 0.4):
        from murcl_tpu.preprocess.slide_io import keep_patch as jax_keep
        assert keep_patch(tile, t, bg) == jax_keep(tile, t, bg)


@pytest.mark.parametrize("method", ["otsu", "adaptive", "rgb"])
@pytest.mark.parametrize("factor", [8, 16])
def test_masks_equal_jax(slides, tmp_path, method, factor):
    want, want_bg = jf.MASK_ALGORITHMS[method](slides[0], factor, str(tmp_path / "j.png"))
    got, got_bg = tf.MASK_ALGORITHMS[method](slides[1], factor, str(tmp_path / "t.png"))
    assert got.dtype == np.uint8 and got.ndim == 2
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_bg, want_bg)
    got_file = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED).astype(int)
    want_file = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    # RGB_filter's file holds the downsampled slide itself
    np.testing.assert_array_equal(got_file, want_file)


@pytest.mark.parametrize("method", ["otsu", "adaptive", "rgb"])
def test_tiling_equals_jax(slides, tmp_path, monkeypatch, method):
    monkeypatch.setattr(jt, "open_slide", lambda _: slides[0])
    monkeypatch.setattr(tt, "open_slide", lambda _, **__: slides[1])
    out = {}
    for side, fn in (("jax", jt.tiling), ("port", tt.tiling)):
        dirs = {k: tmp_path / side / k for k in ("coord", "overview", "mask", "patch")}
        for d in dirs.values():
            d.mkdir(parents=True)
        coord = fn("fake.png", magnification=20, patch_size=64, scale_factor=8,
                   tissue_thresh=0.35, method=method, coord_dir=dirs["coord"],
                   overview_dir=dirs["overview"], mask_dir=dirs["mask"],
                   patch_dir=dirs["patch"] if method == "rgb" else None, filename="fake")
        out[side] = (coord, dirs)
    (jc, jd), (tc, td) = out["jax"], out["port"]
    assert tc == jc and tc["num_patches"] > 0
    assert (td["coord"] / "fake.json").read_text() == (jd["coord"] / "fake.json").read_text()
    for kind in ("overview", "mask"):
        np.testing.assert_array_equal(
            cv2.imread(str(td[kind] / "fake.png"), cv2.IMREAD_UNCHANGED),
            cv2.imread(str(jd[kind] / "fake.png"), cv2.IMREAD_UNCHANGED))
    if method == "rgb":
        names = sorted(p.name for p in (jd["patch"] / "fake").iterdir())
        assert names == sorted(p.name for p in (td["patch"] / "fake").iterdir())
        assert len(names) == tc["num_patches"]
        for name in names[:20]:
            np.testing.assert_array_equal(cv2.imread(str(td["patch"] / "fake" / name)),
                                          cv2.imread(str(jd["patch"] / "fake" / name)))


def test_tiling_magnification_guard_and_bad_method(slides, monkeypatch):
    monkeypatch.setattr(tt, "open_slide", lambda _, **__: slides[1])
    assert tt.tiling("fake.png", magnification=40, patch_size=64, filename="fake") is None
    with pytest.raises(ValueError, match="filter method"):
        tt.tiling("fake.png", magnification=20, patch_size=64, method="nope", filename="fake")


def test_infer_level0_magnification_equals_jax():
    for props in ({"aperio.AppMag": "40"}, {"openslide.mpp-x": "0.25"},
                  {"openslide.mpp-x": "0.5"}, {}):
        s = ImageSlide("x.png", image=np.zeros((4, 4, 3), np.uint8), properties=props)
        assert tt.infer_level0_magnification(s) == jt.infer_level0_magnification(s)


def test_run_tiling_skips_and_names(tmp_path, capsys):
    slide_dir = tmp_path / "slides"
    slide_dir.mkdir()
    img = blob_slide()[::2, ::2]
    for name in ("TCGA-AB-1234-01Z.tif", "TCGA-CD-5678-01Z.tif"):
        Image.fromarray(img).save(slide_dir / name)
        (slide_dir / (name + ".props.json")).write_text('{"aperio.AppMag": "20"}')
    args = Namespace(slide_dir=str(slide_dir), save_dir=str(tmp_path / "out"), exist_ok=False,
                     patch_size=32, magnification=20, scale_factor=8, tissue_thresh=0.35,
                     overview=True, save_mask=True, save_patch=False, wsi_format=".tif",
                     specify_filename=True, filename_l=0, filename_r=12, method="rgb",
                     overview_level=-1)
    tt.run_tiling(args)
    coords = sorted(p.name for p in (tmp_path / "out" / "coord").iterdir())
    assert coords == ["TCGA-AB-1234.json", "TCGA-CD-5678.json"]
    assert len(list((tmp_path / "out" / "overview").iterdir())) == 2
    capsys.readouterr()
    tt.run_tiling(args)
    assert capsys.readouterr().out.count("skipped: coord exists") == 2


def test_draw_contours_against_jax(slides, tmp_path, monkeypatch):
    monkeypatch.setattr(jt, "open_slide", lambda _: slides[0])
    monkeypatch.setattr(jax_hm, "open_slide", lambda _: slides[0])
    monkeypatch.setattr(hm, "open_slide", lambda _, **__: slides[1])
    coord = jt.tiling("fake.png", magnification=20, patch_size=64, scale_factor=8,
                      coord_dir=tmp_path, filename="fake")
    xml = tmp_path / "fake.xml"
    rng = np.random.default_rng(5)
    annotations = []
    for cx, cy in ((900, 700), (1500, 400)):
        ang = np.sort(rng.uniform(0, 2 * np.pi, 25))
        rad = rng.uniform(100, 300, 25)
        pts = "".join(f'<Coordinate Order="{i}" X="{cx + r * np.cos(a):.3f}" '
                      f'Y="{cy + r * np.sin(a):.3f}"/>' for i, (a, r) in enumerate(zip(ang, rad)))
        annotations.append(f"<Annotation><Coordinates>{pts}</Coordinates></Annotation>")
    xml.write_text("<ASAP_Annotations><Annotations>" + "".join(annotations)
                   + "</Annotations></ASAP_Annotations>")
    contours = hm.load_annotations_xml(xml)
    want_contours = jax_hm.load_annotations_xml(xml)
    assert len(contours) == 2
    for a, b in zip(contours, want_contours):
        np.testing.assert_array_equal(a, b)
    attention = rng.normal(size=coord["num_patches"])
    got = hm.create_heatmap(tmp_path / "fake.json", attention, slide_level=0, contours=contours)
    want = jax_hm.create_heatmap(tmp_path / "fake.json", attention, slide_level=0,
                                 contours=want_contours)
    plain = hm.create_heatmap(tmp_path / "fake.json", attention, slide_level=0)
    outline = (want != plain).any(axis=2)
    assert outline.sum() > 1000
    np.testing.assert_array_equal(got, want)
    assert set(map(tuple, got[(got != plain).any(axis=2)])) == {(0, 255, 255)}


class _PilView:
    """A port ``TiffSlide`` as the JAX package's code reads a slide: regions
    and thumbnails as PIL images."""

    def __init__(self, slide):
        self._slide = slide
        self.properties = slide.properties
        self.dimensions = slide.dimensions
        self.level_count = slide.level_count
        self.level_dimensions = slide.level_dimensions
        self.level_downsamples = slide.level_downsamples

    def get_best_level_for_downsample(self, d):
        return self._slide.get_best_level_for_downsample(d)

    def read_region(self, location, level, size):
        return Image.fromarray(self._slide.read_region(location, level, size), "RGBA")

    def get_thumbnail(self, size):
        return Image.fromarray(self._slide.get_thumbnail(size))


@pytest.mark.parametrize("pyramid", [True, False])
def test_tiling_a_tiff_file_equals_jax(tmp_path, monkeypatch, pyramid):
    from murcl_tpu_torch.data.synthetic import aperio_description, write_tiff
    from murcl_tpu_torch.preprocess.slide_io import TiffSlide

    img = blob_slide()
    levels = [img, np.ascontiguousarray(img[::4, ::4]), np.ascontiguousarray(img[::16, ::16])]
    path = tmp_path / "slide.svs"
    write_tiff(path, levels if pyramid else levels[:1], tile=128, compression="deflate",
               predictor=2, description=aperio_description(2048, 1536, 128, app_mag=20))
    jslide = (_PilView(TiffSlide(path)) if pyramid
              else JaxImageSlide("x.png", image=Image.fromarray(img), properties=dict(PROPS)))
    monkeypatch.setattr(jt, "open_slide", lambda _: jslide)
    out = {}
    for side, fn in (("jax", jt.tiling), ("port", tt.tiling)):
        dirs = {k: tmp_path / side / k for k in ("coord", "overview", "mask")}
        for d in dirs.values():
            d.mkdir(parents=True)
        coord = fn(str(path), magnification=20, patch_size=64, scale_factor=32,
                   coord_dir=dirs["coord"], overview_dir=dirs["overview"],
                   mask_dir=dirs["mask"], filename="slide")
        out[side] = (coord, dirs)
    (jc, jd), (tc, td) = out["jax"], out["port"]
    assert tc == jc and tc["num_patches"] > 0
    assert (td["coord"] / "slide.json").read_text() == (jd["coord"] / "slide.json").read_text()
    for kind in ("overview", "mask"):
        np.testing.assert_array_equal(
            cv2.imread(str(td[kind] / "slide.png"), cv2.IMREAD_UNCHANGED),
            cv2.imread(str(jd[kind] / "slide.png"), cv2.IMREAD_UNCHANGED))
