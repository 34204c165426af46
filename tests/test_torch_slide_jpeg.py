"""JPEG-tiled TIFF slides on the CPU, against PIL and libtiff.

- JPEG-tiled TIFFs with JPEGTables (abbreviated tile streams, as libtiff
  and Aperio's scanners write them), in YCbCr 4:4:4 and 4:2:0 and in RGB
  (``keep_rgb``, its Adobe marker stripped, as in Aperio files), read
  through ``TiffSlide`` on the CPU, equal PIL's reading of the same file
  (libtiff) bit for bit, at every level and across tile borders.
- The committed fixtures ``murcl_tpu_torch/preprocess/fixtures/jpeg_tiles.npz``
  and ``jpeg_tiles_256.npz`` (the card's nvJPEG is held against them in
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``) equal PIL's decode
  of their own streams.
- With PIL blocked, a JPEG tile on the CPU is refused by name, and a file
  of another codec still reads; asked for the card without libnvjpeg, a
  JPEG tile raises naming it (no fallback to PIL).
- ``ycc_to_rgb`` (the card's upsampling and colour conversion) equals
  PIL's decode given libjpeg's own planes.

``python tests/test_torch_slide_jpeg.py`` writes the fixtures anew.
"""

import io
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from murcl_tpu_torch.data.synthetic import write_tiff
from murcl_tpu_torch.preprocess.nvjpeg import decode_pil, load_fixture
from murcl_tpu_torch.preprocess.slide_io import TiffSlide, open_slide

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "murcl_tpu_torch" / "preprocess" / "fixtures" / "jpeg_tiles.npz"
FIXTURE_256 = FIXTURE.with_name("jpeg_tiles_256.npz")
VARIANTS = {"ycbcr444": (6, (1, 1)), "ycbcr420": (6, (2, 2)), "rgb": (2, None)}


def split_jpeg(full: bytes):
    """A whole JPEG stream -> (JPEGTables: SOI, DQT and DHT, EOI; the
    abbreviated stream: SOI, the frame and scan, no tables and no APPn)."""
    i, segs = 2, []
    while i < len(full):
        marker = full[i + 1]
        if marker == 0xDA:  # the scan runs to the end
            segs.append((marker, full[i:]))
            break
        n = int.from_bytes(full[i + 2:i + 4], "big")
        segs.append((marker, full[i:i + 2 + n]))
        i += 2 + n
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    tile = b"\xff\xd8" + b"".join(s for m, s in segs
                                  if m not in (0xDB, 0xC4) and not 0xE0 <= m <= 0xEF)
    return tables, tile


def encode_jpeg(tile: np.ndarray, variant: str, quality: int = 85) -> bytes:
    buf = io.BytesIO()
    if variant == "rgb":
        Image.fromarray(tile).save(buf, "JPEG", quality=quality, keep_rgb=True, subsampling=0)
    else:
        Image.fromarray(tile).save(buf, "JPEG", quality=quality,
                                   subsampling=0 if variant == "ycbcr444" else 2)
    return buf.getvalue()


def tissue_image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth pink texture with a dark stroke: what a stained slide's JPEG
    tiles hold, at a size that compresses well."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC)).astype(np.int64)
    img = img // 3 + np.array([150, 90, 140])
    img[h // 3:h // 3 + 5, w // 8:w - w // 8] = (60, 20, 90)
    return img.clip(0, 255).astype(np.uint8)


def jpeg_spec(variant: str, img: np.ndarray, tile: int):
    """``write_tiff``'s ``jpeg`` argument for ``img`` cut into ``tile``s."""
    photometric, sub = VARIANTS[variant]
    tables, _ = split_jpeg(encode_jpeg(np.ascontiguousarray(img[:tile, :tile]), variant))
    return (tables, lambda t: split_jpeg(encode_jpeg(np.ascontiguousarray(t), variant))[1],
            photometric, sub)


def make_fixture(path=FIXTURE, tile: int = 48, variants=tuple(VARIANTS)) -> None:
    """Per variant, the JPEGTables, four abbreviated tile streams of a
    2 x 2-tile image and PIL's decode of each, stored as its differences
    across, then down (modulo 256: smooth tiles compress to a third)."""
    arrays = {}
    for variant in variants:
        img = tissue_image(2 * tile, 2 * tile, seed=list(VARIANTS).index(variant))
        tables, encode, photometric, _ = jpeg_spec(variant, img, tile)
        streams = [encode(img[y:y + tile, x:x + tile]) for y in (0, tile) for x in (0, tile)]
        arrays[f"{variant}_tables"] = np.frombuffer(tables, np.uint8)
        arrays[f"{variant}_streams"] = np.frombuffer(b"".join(streams), np.uint8)
        arrays[f"{variant}_lengths"] = np.array([len(s) for s in streams], np.int64)
        arrays[f"{variant}_photometric"] = np.array(photometric)
        decoded = np.stack([decode_pil(tables[:-2] + s[2:], photometric) for s in streams])
        across = np.diff(decoded, axis=2, prepend=np.uint8(0))  # uint8: modulo 256
        arrays[f"{variant}_decoded_delta"] = np.diff(across, axis=1, prepend=np.uint8(0))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def read_all(slide, level):
    w, h = slide.level_dimensions[level]
    return slide.read_region((0, 0), level, (w, h))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jpeg_tiff_equals_libtiff(tmp_path, variant):
    img = tissue_image(200, 300, seed=5)
    levels = [img, np.ascontiguousarray(img[::2, ::2])]
    path = tmp_path / f"{variant}.tif"
    write_tiff(path, levels, tile=64, compression="jpeg", jpeg=jpeg_spec(variant, img, 64))
    slide = TiffSlide(path, device="cpu")
    assert slide.level_count == 2
    with Image.open(path) as im:
        for level in range(2):
            im.seek(level)
            want = np.asarray(im.convert("RGB"))
            got = read_all(slide, level)
            assert got.shape == want.shape[:2] + (4,)
            np.testing.assert_array_equal(got[..., :3], want)
            assert (got[..., 3] == 255).all()
    # across tile borders, at level 0, and past the slide's edge
    region = slide.read_region((50, 40), 0, (100, 90))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(region[..., :3], want[40:130, 50:150])
    edge = slide.read_region((280, 190), 0, (40, 30))
    np.testing.assert_array_equal(edge[:10, :20, :3], want[190:, 280:])
    assert (edge[10:] == 0).all() and (edge[:, 20:] == 0).all()
    slide.close()


def test_fixture_equals_pils_decode():
    _check_fixture(FIXTURE, 48, tuple(VARIANTS))


def test_fixture_256_equals_pils_decode():
    _check_fixture(FIXTURE_256, 256, ("ycbcr420",))


def _check_fixture(path, tile, variants):
    assert path.stat().st_size < (100_000 if tile == 48 else 300_000)
    fixture = load_fixture(path)
    assert tuple(fixture) == variants
    for variant, fx in fixture.items():
        assert fx["photometric"] == VARIANTS[variant][0]
        assert fx["decoded"].shape == (4, tile, tile, 3) and len(fx["streams"]) == 4
        for stream, want in zip(fx["streams"], fx["decoded"]):
            assert stream[:2] == b"\xff\xd8" and b"\xff\xdb" not in stream[:4]
            np.testing.assert_array_equal(decode_pil(fx["tables"][:-2] + stream[2:],
                                                     fx["photometric"]), want)


@pytest.mark.parametrize("subsampling", [0, 2])
def test_ycc_to_rgb_is_libjpegs(subsampling):
    """The card's upsampling and colour conversion (``ycc_to_rgb``, run on
    nvJPEG's planes) against PIL's RGB decode, given libjpeg's own planes:
    luma from a YCbCr decode, and 4:2:0 chroma before upsampling from a
    decode at half scale (where libjpeg keeps chroma's 8 x 8 IDCT and skips
    the upsampling)."""
    import torch

    from murcl_tpu_torch.preprocess.nvjpeg import ycc_to_rgb

    for seed in range(3):
        img = (tissue_image(96, 80, seed) if seed < 2
               else np.random.default_rng(seed).integers(0, 256, (96, 80, 3), dtype=np.uint8))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=subsampling)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        full = Image.open(io.BytesIO(buf.getvalue()))
        full.draft("YCbCr", full.size)
        full = np.asarray(full)
        chroma = full
        if subsampling == 2:
            half = Image.open(io.BytesIO(buf.getvalue()))
            half.draft("YCbCr", (40, 48))
            chroma = np.asarray(half)
            assert chroma.shape == (48, 40, 3)
        planes = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                  (full[..., 0], chroma[..., 1], chroma[..., 2])]
        np.testing.assert_array_equal(ycc_to_rgb(*planes).numpy(), want)


def test_jpeg_refused_by_name_without_pil(tmp_path):
    img = tissue_image(128, 128, seed=1)
    write_tiff(tmp_path / "j.tif", [img], tile=64, compression="jpeg",
               jpeg=jpeg_spec("ycbcr420", img, 64))
    write_tiff(tmp_path / "d.tif", [img], tile=64, compression="deflate")
    code = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None  # blocked
        from murcl_tpu_torch.preprocess.slide_io import open_slide
        s = open_slide({str(tmp_path / "d.tif")!r}, device="cpu")
        assert s.read_region((0, 0), 0, (128, 128)).shape == (128, 128, 4)
        s = open_slide({str(tmp_path / "j.tif")!r}, device="cpu")
        try:
            s.read_region((0, 0), 0, (64, 64))
        except RuntimeError as e:
            assert "JPEG" in str(e) and "PIL" in str(e), e
            print("refused:", e)
        else:
            raise SystemExit("a JPEG tile was read without PIL")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "refused:" in out.stdout


def test_card_without_libnvjpeg_raises_by_name(tmp_path, monkeypatch):
    """Asked for the card, a JPEG tile never falls back to PIL: without
    libnvjpeg the read raises, naming it."""
    import ctypes.util

    from murcl_tpu_torch.preprocess import nvjpeg

    img = tissue_image(64, 64, seed=3)
    write_tiff(tmp_path / "j.tif", [img], tile=64, compression="jpeg",
               jpeg=jpeg_spec("ycbcr444", img, 64))
    monkeypatch.setattr(nvjpeg, "_lib", None)
    monkeypatch.setattr(nvjpeg, "library_candidates", lambda: [])
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    slide = open_slide(tmp_path / "j.tif", device="cuda:0")
    with pytest.raises(RuntimeError, match="libnvjpeg"):
        slide.read_region((0, 0), 0, (64, 64))


def test_create_patches_stops_without_the_decoder(tmp_path, monkeypatch, capsys):
    """A decoder that cannot run fails every JPEG slide alike, so tiling stops
    with its error, naming libnvjpeg, instead of skipping each slide as one
    bad file (a slide that fails on its own is still skipped)."""
    import ctypes.util

    from murcl_tpu_torch import create_patches
    from murcl_tpu_torch.preprocess import nvjpeg

    img = tissue_image(256, 256, seed=4)
    slides = tmp_path / "slides"
    slides.mkdir()
    (slides / "a_broken.tif").write_bytes(b"II*\x00")
    write_tiff(slides / "b.tif", [img], tile=64, compression="jpeg",
               jpeg=jpeg_spec("ycbcr420", img, 64))
    monkeypatch.setattr(nvjpeg, "_lib", None)
    monkeypatch.setattr(nvjpeg, "library_candidates", lambda: [])
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # --device passes
    with pytest.raises(nvjpeg.DecoderUnavailable, match="libnvjpeg"):
        create_patches.main(["--slide_dir", str(slides), "--save_dir", str(tmp_path / "out"),
                             "--patch_size", "32", "--scale_factor", "4", "--wsi_format", ".tif",
                             "--magnification", "20", "--device", "cuda:0"])
    assert "a_broken Error!" in capsys.readouterr().out


def test_open_slide_reads_jpeg_on_the_cpu(tmp_path):
    img = tissue_image(96, 160, seed=2)
    path = tmp_path / "s.svs"
    write_tiff(path, [img], tile=32, compression="jpeg", jpeg=jpeg_spec("rgb", img, 32),
               svs_extras=True)
    slide = open_slide(path, device="cpu")
    assert isinstance(slide, TiffSlide) and slide.level_count == 1
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_all(slide, 0)[..., :3], np.asarray(im.convert("RGB")))


if __name__ == "__main__":
    make_fixture()
    make_fixture(FIXTURE_256, tile=256, variants=("ycbcr420",))
    for path in (FIXTURE, FIXTURE_256):
        print(f"wrote {path} ({path.stat().st_size} bytes)")
