"""The port's TIFF/SVS slide reader (``preprocess/tiff.py``, ``TiffSlide``)
against the pixels it was given, OpenSlide's rules, PIL and the JAX package.

- ``read_region`` equals the source array bit for bit at every level,
  across tile borders and past the slide's edge (transparent black), for
  tiled and stripped images, TIFF and BigTIFF, both byte orders, each
  lossless codec (none, deflate, Adobe deflate, LZW, PackBits) with and
  without Predictor 2 where libtiff applies it (LZW, deflate), RGB and
  RGBA, and Aperio's ``.svs`` layout, whose thumbnail, label and macro are
  not levels.
- OpenSlide's rules: ``level_downsamples`` the mean of the two axes'
  ratios, ``get_best_level_for_downsample`` and ``get_thumbnail``.
- ``properties`` from an Aperio ImageDescription and from XResolution in
  centimetres and in inches, and a ``.props.json`` sidecar over them.
- Files PIL writes (``tiff_lzw``, ``packbits``, ``tiff_adobe_deflate``,
  raw) read bit for bit; an unsupported codec is refused by its name.
- Level 0 of a single-level file equals the JAX package's ``ImageSlide``
  of the same pixels.
- The tile cache stays within its bytes under many threads.
"""

import itertools
import struct
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from murcl_tpu.preprocess.slide_io import ImageSlide as JaxImageSlide
from murcl_tpu_torch.data.synthetic import aperio_description, synthetic_slide, write_tiff
from murcl_tpu_torch.preprocess.slide_io import TileCache, TiffSlide, open_slide
from murcl_tpu_torch.preprocess.tiff import TiffFile

CODECS = [("none", 1), ("deflate", 1), ("deflate", 2), ("adobe_deflate", 1),
          ("adobe_deflate", 2), ("lzw", 1), ("lzw", 2), ("packbits", 1)]


def _levels(channels=3):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (203, 311, channels), dtype=np.uint8)
    img[50:90] = 240  # runs, for the run-length codecs
    return [img, np.ascontiguousarray(img[::2, ::2]), np.ascontiguousarray(img[::5, ::5])]


def _check_regions(slide, levels):
    w0, h0 = slide.dimensions
    for k, src in enumerate(levels):
        h, w = src.shape[:2]
        assert slide.level_dimensions[k] == (w, h)
        whole = slide.read_region((0, 0), k, (w, h))
        np.testing.assert_array_equal(whole[..., :3], src[..., :3])
        assert (whole[..., 3] == 255).all()
        ds = slide.level_downsamples[k]
        # across tile borders, and past the right and bottom edges
        for x, y, rw, rh in ((3, 5, 70, 41), (w - 20, h - 9, 45, 30), (-7, -3, 20, 15)):
            region = slide.read_region((int(round(x * ds)), int(round(y * ds))), k, (rw, rh))
            x0 = int(np.floor(round(x * ds) / ds)) if k else x
            y0 = int(np.floor(round(y * ds) / ds)) if k else y
            want = np.zeros((rh, rw, 4), np.uint8)
            xa, ya = max(x0, 0), max(y0, 0)
            crop = src[ya:y0 + rh, xa:x0 + rw, :3]
            want[ya - y0:ya - y0 + crop.shape[0], xa - x0:xa - x0 + crop.shape[1], :3] = crop
            want[ya - y0:ya - y0 + crop.shape[0], xa - x0:xa - x0 + crop.shape[1], 3] = 255
            np.testing.assert_array_equal(region, want)
            if k == 0:  # the patch readers' RGB path
                np.testing.assert_array_equal(slide.read_rgb((x, y), (rw, rh)), want[..., :3])
    assert slide.read_region((w0 + 5, 0), 0, (4, 4)).sum() == 0


@pytest.mark.parametrize("codec,predictor", CODECS)
@pytest.mark.parametrize("bigtiff,byteorder", [(False, "<"), (True, ">")])
def test_tiled_pyramid_reads_bitwise(tmp_path, codec, predictor, bigtiff, byteorder):
    levels = _levels()
    path = tmp_path / "s.tif"
    write_tiff(path, levels, tile=64, compression=codec, predictor=predictor, bigtiff=bigtiff,
               byteorder=byteorder)
    slide = TiffSlide(path)
    assert slide.level_count == 3
    _check_regions(slide, levels)
    slide.close()


@pytest.mark.parametrize("codec", ["deflate", "lzw"])
def test_large_read_on_threads_bitwise(tmp_path, codec):
    """A read of more than ``LARGE_READ`` tiles (a level read whole, as a
    single-level file's downsample reads it) decodes each row of tiles on 8
    threads, to the same pixels, and past the edge too."""
    from murcl_tpu_torch.preprocess.slide_io import LARGE_READ

    img = _levels()[0]
    path = tmp_path / "s.tif"
    write_tiff(path, [img], tile=16, compression=codec)
    slide = TiffSlide(path, cache_bytes=1 << 16)  # fewer tiles than the read spans
    assert -(-203 // 16) * -(-311 // 16) > LARGE_READ
    whole = slide.read_region((-5, -3), 0, (320, 210))
    want = np.zeros((210, 320, 4), np.uint8)
    want[3:206, 5:316, :3], want[3:206, 5:316, 3] = img, 255
    np.testing.assert_array_equal(whole, want)
    slide.close()


@pytest.mark.parametrize("codec,predictor", [("none", 1), ("deflate", 2), ("lzw", 1),
                                             ("packbits", 1)])
@pytest.mark.parametrize("channels", [3, 4])
def test_stripped_reads_bitwise(tmp_path, codec, predictor, channels):
    levels = _levels(channels)[:1]
    path = tmp_path / "s.tif"
    write_tiff(path, levels, tile=17, compression=codec, predictor=predictor, stripped=True)
    slide = TiffSlide(path)
    assert slide.level_count == 1
    _check_regions(slide, levels)
    with Image.open(path) as im:  # libtiff agrees
        np.testing.assert_array_equal(np.asarray(im), levels[0])


def test_svs_layout_levels_and_properties(tmp_path):
    levels = _levels()
    path = tmp_path / "s.svs"
    write_tiff(path, levels, tile=64, svs_extras=True,
               description=aperio_description(311, 203, 64, app_mag=20, mpp=0.499))
    tf = TiffFile(path)
    kinds = [(p.tiled, p.subfile_type) for p in tf.pages]
    assert kinds == [(True, 0), (False, 0), (True, 0), (True, 0), (False, 1), (False, 9)]
    assert [p.index for p in tf.levels] == [0, 2, 3]
    tf.close()
    slide = open_slide(path)
    assert isinstance(slide, TiffSlide) and slide.level_count == 3
    _check_regions(slide, levels)
    props = slide.properties
    assert props["aperio.AppMag"] == "20" and props["aperio.MPP"] == "0.4990"
    assert props["openslide.mpp-x"] == "0.4990" and props["openslide.objective-power"] == "20"


@pytest.mark.parametrize("unit,res,mpp", [(3, 40000.0, 0.25), (2, 50800.0, 0.5)])
def test_properties_from_resolution_and_sidecar(tmp_path, unit, res, mpp):
    path = tmp_path / "g.tif"
    write_tiff(path, _levels()[:1], tile=64, resolution=(res, unit))
    slide = TiffSlide(path)
    assert float(slide.properties["openslide.mpp-x"]) == pytest.approx(mpp, rel=1e-9)
    assert "aperio.AppMag" not in slide.properties
    (tmp_path / "g.tif.props.json").write_text('{"aperio.AppMag": "40"}')
    assert TiffSlide(path).properties["aperio.AppMag"] == "40"


def test_openslide_downsample_rules(tmp_path):
    img = np.zeros((700, 1001, 3), np.uint8)
    levels = [img, img[:175, :250].copy(), img[:43, :62].copy()]
    write_tiff(tmp_path / "p.tif", levels, tile=32, compression="deflate")
    slide = TiffSlide(tmp_path / "p.tif")
    ds = slide.level_downsamples
    assert ds[0] == 1.0
    assert ds[1] == (1001 / 250 + 700 / 175) / 2 and ds[2] == (1001 / 62 + 700 / 43) / 2
    best = slide.get_best_level_for_downsample
    assert [best(d) for d in (0.5, 1.0, 3.9, ds[1], 16.0, ds[2], 100.0)] == [0, 0, 0, 1, 1, 2, 2]
    # OpenSlide's get_thumbnail: at a level's own size, that level's pixels
    thumb = slide.get_thumbnail(slide.level_dimensions[1])
    assert thumb.shape == (175, 250, 3)
    small = slide.get_thumbnail((100, 100))
    assert small.shape == (70, 100, 3)


@pytest.mark.parametrize("compression", ["tiff_lzw", "packbits", "tiff_adobe_deflate", "raw"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_files_pil_writes(tmp_path, compression, mode):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (157, 233, len(mode)), dtype=np.uint8)
    img[:40] = 17
    path = tmp_path / "p.tif"
    Image.fromarray(img, mode).save(path, compression=compression)
    slide = TiffSlide(path)
    got = slide.read_region((0, 0), 0, (233, 157))
    np.testing.assert_array_equal(got[..., :3], img[..., :3])


def test_unsupported_codec_refused_by_name(tmp_path):
    path = tmp_path / "j2k.svs"
    write_tiff(path, _levels()[:1], tile=64, compression="none")
    data = bytearray(path.read_bytes())
    entry = struct.pack("<HHII", 259, 3, 1, 1)  # Compression = 1, inline
    at = data.index(entry)
    data[at:at + 12] = struct.pack("<HHII", 259, 3, 1, 33003)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"JPEG 2000.*33003"):
        TiffSlide(path)


def test_single_level_equals_jax_image_slide(tmp_path):
    img = synthetic_slide(256, 384, seed=3)
    write_tiff(tmp_path / "s.tif", [img], tile=96, compression="lzw", predictor=2)
    ours = TiffSlide(tmp_path / "s.tif")
    theirs = JaxImageSlide("s.png", image=Image.fromarray(img))
    assert ours.dimensions == theirs.dimensions
    # past the right and bottom edges (left of or above the slide, the JAX
    # fallback's PIL crop gives opaque black, OpenSlide transparent black)
    for loc, size in (((0, 0), (384, 256)), ((100, 37), (64, 64)), ((350, 240), (64, 64))):
        np.testing.assert_array_equal(ours.read_region(loc, 0, size),
                                      np.asarray(theirs.read_region(loc, 0, size)))
    np.testing.assert_array_equal(ours.get_thumbnail((384, 256)),
                                  np.asarray(theirs.get_thumbnail((384, 256))))


def test_tile_cache_bounded_under_threads(tmp_path):
    levels = _levels()
    write_tiff(tmp_path / "s.tif", levels, tile=32, compression="deflate")
    slide = TiffSlide(tmp_path / "s.tif", cache_bytes=20 * 32 * 32 * 3)
    rng = np.random.default_rng(0)
    jobs = [(int(x), int(y)) for x, y in rng.integers(0, 280, (400, 2))]
    errors = []

    def work(part):
        try:
            for x, y in part:
                got = slide.read_region((x, y), 0, (40, 30))[..., :3]
                want = np.zeros((30, 40, 3), np.uint8)
                crop = levels[0][y:y + 30, x:x + 40]
                want[:crop.shape[0], :crop.shape[1]] = crop
                if not np.array_equal(got, want):
                    errors.append((x, y))
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(jobs[i::16],)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    cache = slide.cache
    assert cache._bytes == sum(t.nbytes for t in cache._tiles.values()) <= cache.max_bytes
    assert cache.hits > 0 and cache.misses > 0


def test_tile_cache_lru_order():
    cache = TileCache(3 * 8)
    tiles = {k: np.full(8, k, np.uint8) for k in range(5)}
    for k in (0, 1, 2):
        cache.put(k, tiles[k])
    assert cache.get(0) is tiles[0]  # 0 is now the newest
    cache.put(3, tiles[3])  # evicts 1, the oldest
    assert cache.get(1) is None and cache.get(2) is tiles[2] and cache.get(3) is tiles[3]
    cache.put(9, np.zeros(100, np.uint8))  # larger than the cache: not kept
    assert cache.get(9) is None


def test_png_and_other_images_route(tmp_path):
    from murcl_tpu_torch.preprocess.slide_io import ImageSlide
    from murcl_tpu_torch.utils.png import write_png

    img = synthetic_slide(256, 384, seed=1)
    write_png(tmp_path / "s.png", img[..., ::-1])
    slide = open_slide(tmp_path / "s.png")
    assert isinstance(slide, ImageSlide)
    np.testing.assert_array_equal(slide.read_region((0, 0), 0, (384, 256))[..., :3], img)
    Image.fromarray(img).save(tmp_path / "s.bmp")
    assert isinstance(open_slide(tmp_path / "s.bmp"), ImageSlide)


@pytest.mark.parametrize("codec", ["deflate", "lzw"])
def test_writer_codecs_round_trip_pil(tmp_path, codec):
    """write_tiff's files as libtiff reads them, for the tests that read them."""
    levels = _levels()
    for big, strip in itertools.product((False,), (False, True)):
        path = tmp_path / f"{big}{strip}.tif"
        write_tiff(path, levels[:1], tile=32, compression=codec, predictor=2, stripped=strip)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), levels[0])
