"""The port's heatmap slice against the JAX package and OpenCV.

- Painting: the JET table equals ``cv2.applyColorMap`` for all 256 levels,
  the blend equals ``cv2.addWeighted``, ``create_heatmap`` equals the JAX
  package's bitwise on the fixture slide of ``tests/test_preprocess.py``,
  and the PNG writer's file reads back with ``cv2.imread`` as the array.
- ``AttentionScorer`` against the JAX scorer on the same checkpoint (the
  JAX one on its XLA route), f32, scores to 1e-5: a 40-patch bag (K2's
  route in the port) and a 4,000-patch one (trunk output over 6 MiB: K8's).
- ``WSIDataset`` items equal the JAX class's under the same numpy seed, and
  ``python -m murcl_tpu_torch.create_heatmaps --device cpu`` writes one PNG
  of the thumbnail's shape per slide.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import murcl_tpu.preprocess.heatmaps as jax_hm
from murcl_tpu.data.datasets import WSIDataset as JaxWSIDataset
from murcl_tpu.preprocess.slide_io import ImageSlide as JaxImageSlide
from murcl_tpu_torch.data.datasets import WSIDataset
from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
from murcl_tpu_torch.engine.weights import jax_from_params, params_from_jax
from murcl_tpu_torch.models import CL, CLAM_SB
from murcl_tpu_torch.ops import attention as tat
from murcl_tpu_torch.preprocess import heatmaps as hm
from murcl_tpu_torch.preprocess.slide_io import ImageSlide
from murcl_tpu_torch.utils.png import write_png

REPO = Path(__file__).resolve().parents[1]


def _fake_slide_array():
    """``tests/test_preprocess.py:15-34``'s 2048 x 1536 slide."""
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


def test_jet_equals_cv2_colormap():
    levels = np.arange(256, dtype=np.uint8).reshape(-1, 1)
    np.testing.assert_array_equal(hm.JET, cv2.applyColorMap(levels, cv2.COLORMAP_JET)[:, 0])


def test_blend_equals_cv2_add_weighted():
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (97, 131, 3), dtype=np.uint8) for _ in range(2))
    np.testing.assert_array_equal(hm.blend(a, b), cv2.addWeighted(a, 0.5, b, 0.5, 0))


def test_create_heatmap_bitwise_with_jax(tmp_path, monkeypatch):
    import importlib

    tiling = importlib.import_module("murcl_tpu.preprocess.tiling")
    img = _fake_slide_array()
    jslide = JaxImageSlide("fake.png", image=Image.fromarray(img),
                           properties={"aperio.AppMag": "20"})
    monkeypatch.setattr(tiling, "open_slide", lambda _: jslide)
    monkeypatch.setattr(jax_hm, "open_slide", lambda _: jslide)
    monkeypatch.setattr(hm, "open_slide",
                        lambda _: ImageSlide("fake.png", image=img,
                                             properties={"aperio.AppMag": "20"}))
    coord = tiling.tiling("fake.png", magnification=20, patch_size=64, scale_factor=8,
                          coord_dir=tmp_path, filename="fake")
    attention = np.random.default_rng(0).normal(size=coord["num_patches"])
    for level in (0, -1):
        got = hm.create_heatmap(tmp_path / "fake.json", attention, slide_level=level)
        want = jax_hm.create_heatmap(tmp_path / "fake.json", attention, slide_level=level)
        assert got.shape == (1536, 2048, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="item 15"):
        hm.create_heatmap(tmp_path / "fake.json", attention, contours=[])


def test_thumbnail_equals_jax_image_slide():
    img = _fake_slide_array()[:300, :500]
    ours, theirs = ImageSlide("s.png", image=img), JaxImageSlide("s.png",
                                                                  image=Image.fromarray(img))
    for size in ((500, 300), (640, 480), (123, 77)):
        np.testing.assert_array_equal(ours.get_thumbnail(size),
                                      np.asarray(theirs.get_thumbnail(size)))
    np.testing.assert_array_equal(ours.read_region((450, 250), 0, (64, 64)),
                                  np.asarray(theirs.read_region((450, 250), 0, (64, 64))))


def test_png_reads_back_with_cv2(tmp_path):
    arr = np.random.default_rng(2).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    write_png(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), arr)


def test_scorer_matches_jax(tmp_path, monkeypatch):
    """Both scorers load one 128-class MuRCL checkpoint (the port's in torch
    keys, the JAX one as its tree): the instance classifiers and the
    ``classifiers`` head stay fresh on both sides, the rest is the
    checkpoint's, and the scores agree."""
    source = CLAM_SB(in_dim=16, n_classes=128, subtyping=True)
    torch.save({"model_state_dict": CL(source).state_dict()}, tmp_path / "port.pth.tar")
    with open(tmp_path / "jax.pkl", "wb") as fp:
        pickle.dump({"model_state_dict": jax_from_params(source.state_dict())[0]}, fp)

    jscorer = jax_hm.AttentionScorer(dim_patch=16, num_classes=2, bucket=32,
                                     checkpoint=str(tmp_path / "jax.pkl"))
    scorer = hm.AttentionScorer(dim_patch=16, num_classes=2, bucket=32,
                                checkpoint=str(tmp_path / "port.pth.tar"), device="cpu")
    want_sd = params_from_jax(jscorer.params)[0]
    for k, v in scorer.model.state_dict().items():
        if not k.startswith(("classifiers.", "instance_classifiers.")):
            assert torch.equal(v, want_sd[k]) and torch.equal(v, source.state_dict()[k]), k

    tiled = []
    orig = tat.attention_pool_tiled

    def spy(*a, **k):
        tiled.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(tat, "attention_pool_tiled", spy)
    rng = np.random.default_rng(3)
    for n in (40, 4000):
        feats = rng.normal(size=(n, 16)).astype(np.float32)
        got, want = scorer(feats), jscorer(feats)
        assert got.shape == (n,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tiled == [(1, 4000, 512)]


def test_scorer_defaults_to_the_card(monkeypatch):
    """Without a device the scorer takes the card ``cuda:0``: on a host
    without CUDA it raises, naming it, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0 needs a CUDA device"):
        hm.AttentionScorer(dim_patch=16, num_classes=2, bucket=32)
    assert hm.AttentionScorer(dim_patch=16, num_classes=2, device="cpu").device.type == "cpu"


def test_wsidataset_matches_jax(tmp_path):
    ds = generate_synthetic_dataset(tmp_path, num_slides=3, dim=8, min_patches=20,
                                    max_patches=40)
    for kw in (dict(), dict(num_sample_patches=16, patch_random=True),
               dict(num_sample_patches=30, fixed_size=True, preload=False)):
        ours, theirs = WSIDataset(ds["data_csv"], **kw), JaxWSIDataset(ds["data_csv"], **kw)
        assert len(ours) == len(theirs) == 3 and ours.patch_dim == theirs.patch_dim == 8
        for i in range(3):
            np.random.seed(i)
            got = ours[i]
            np.random.seed(i)
            want = theirs[i]
            np.testing.assert_array_equal(got[0], want[0])
            assert got[0].dtype == np.float32 and got[1:] == want[1:]
    # an explicit generator makes the draws reproducible without numpy's global seed
    ours = WSIDataset(ds["data_csv"], num_sample_patches=16, rng=np.random.default_rng(4))
    again = WSIDataset(ds["data_csv"], num_sample_patches=16, rng=np.random.default_rng(4))
    for i in range(3):
        np.testing.assert_array_equal(ours[i][0], again[i][0])


def test_cli_writes_one_png_per_slide(tmp_path):
    ds = generate_synthetic_dataset(tmp_path / "data", num_slides=2, dim=16, min_patches=30,
                                    max_patches=60)
    coord_dir = tmp_path / "coords"
    coord_dir.mkdir()
    shapes = {}
    for case_id, row in zip(ds["case_ids"], range(2)):
        n = np.load(tmp_path / "data" / "features" / f"{case_id}.npz")["img_features"].shape[0]
        side = int(np.ceil(np.sqrt(n)))
        slide = tmp_path / f"{case_id}.png"
        img = np.random.default_rng(row).integers(0, 256, (side * 8 + 3, side * 8, 3),
                                                  dtype=np.uint8)
        write_png(slide, img)
        shapes[case_id] = img.shape
        coords = [{"row": i // side, "col": i % side, "x": 8 * (i % side), "y": 8 * (i // side)}
                  for i in range(n)]
        (coord_dir / f"{case_id}.json").write_text(json.dumps({
            "slide_filepath": str(slide), "magnification": 20, "magnification_level0": 20,
            "num_row": side, "num_col": side, "patch_size": 8, "patch_size_level0": 8,
            "num_patches": n, "coords": coords}))
    out = subprocess.run(
        [sys.executable, "-m", "murcl_tpu_torch.create_heatmaps", "--device", "cpu",
         "--data_csv", ds["data_csv"], "--coord_dir", str(coord_dir), "--save_dir",
         str(tmp_path / "heatmaps"), "--bucket", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    written = sorted(p.stem for p in (tmp_path / "heatmaps").glob("*.png"))
    assert written == sorted(ds["case_ids"])
    for case_id, shape in shapes.items():
        assert cv2.imread(str(tmp_path / "heatmaps" / f"{case_id}.png")).shape == shape
