"""The port's image encoders and feature extraction against the JAX package's.

- ResNet18, ResNet50 and VGG16 in f32 on 64 x 64 inputs, on random flax
  weights (BatchNorm statistics randomised) carried across by
  ``state_dict_from_jax``: within rtol 2e-4 / atol 2e-5, the JAX package's
  own bound (``tests/test_preprocess.py:321``).
- ``resnet_params_from_torch`` / ``vgg16_params_from_torch`` of
  ``state_dict_from_jax(p)`` give ``p`` back exactly.
- ``load_params_npz`` reads the pickle ``scripts/export_torchvision_weights.py``
  writes (run in a subprocess) and refuses one with a foreign global or
  with leaves that are not arrays.
- ``PatchEncoder`` on the CPU against the JAX ``PatchEncoder`` on the same
  weights file: the host path, ``imagenet_norm``, and ``resize_on_device``
  (antialiased bilinear, 64 -> 32) within the same bound.
- ``_read_patches`` (threads) and ``ProcessDecodePool`` read the same
  pixels; a decode worker has not initialised CUDA.
- ``extract_features`` over the blob slide's coord json: the same
  ``coords``, ``num_row`` and ``num_col`` as the JAX package's npz, and
  ``img_features`` within rtol 1e-3 / atol 1e-3 (the patches, resized
  64 -> 32 on the host, equal PIL's; the convolutions' sums differ).
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from murcl_tpu.preprocess import extract as jx
from murcl_tpu.preprocess import resnet as jr
from murcl_tpu.preprocess.slide_io import ImageSlide as JaxImageSlide
from murcl_tpu_torch.preprocess import extract as tx
from murcl_tpu_torch.preprocess import resnet as tr
from murcl_tpu_torch.preprocess.decode_pool import ProcessDecodePool
from murcl_tpu_torch.preprocess.resample import resize_u8
from murcl_tpu_torch.preprocess.slide_io import ImageSlide
from murcl_tpu_torch.utils.general import dump_json
from test_torch_preprocess_cv import blob_slide

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("scale", "var"):
            out[k] = (0.5 + rng.uniform(size=v.shape)).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_params(name, seed=0, size=64):
    model, _ = jr.create_encoder(name)
    init = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, size, size, 3), jnp.float32)))
    return model, {"params": _randomize(init["params"], np.random.default_rng(seed))}


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vgg16"])
def test_encoder_matches_jax(name):
    model, params = jax_params(name)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(model.apply(params, x))
    enc, dim = tr.create_encoder(name)
    enc.load_state_dict(tr.state_dict_from_jax(params, name), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, dim) == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vgg16"])
def test_state_dict_round_trip(name):
    _, params = jax_params(name)
    sd = tr.state_dict_from_jax(params, name)
    assert set(sd) == set(tr.create_encoder(name)[0].state_dict())
    if name == "vgg16":
        back = jr.vgg16_params_from_torch(sd)
    else:
        back = jr.resnet_params_from_torch(sd, *tr.RESNET_ARCH[name])
    flat = lambda t, p="": ({f"{p}/{k}": v for kk, vv in t.items()  # noqa: E731
                             for k, v in flat(vv, kk).items()} if isinstance(t, dict)
                            else {p: t})
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_params_npz_reads_export_script_pickle(tmp_path):
    _, params = jax_params("resnet18")
    ckpt, out = tmp_path / "resnet18.pth", tmp_path / "resnet18.pkl"
    torch.save(tr.state_dict_from_jax(params, "resnet18"), ckpt)
    r = subprocess.run([sys.executable, str(REPO / "scripts/export_torchvision_weights.py"),
                        "--encoder", "resnet18", "--state_dict", str(ckpt), "--out", str(out)],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    loaded = tr.load_params_npz(out)
    enc, _ = tr.create_encoder("resnet18")
    enc.load_state_dict(tr.state_dict_from_jax(loaded, "resnet18"), strict=True)
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    want = np.asarray(jr.create_encoder("resnet18")[0].apply(params, x))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    evil = tmp_path / "evil.pkl"
    evil.write_bytes(pickle.dumps({"params": {"x": print}}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tr.load_params_npz(evil)
    jax_leaf = tmp_path / "jax_leaf.pkl"
    with open(jax_leaf, "wb") as fp:
        pickle.dump({"params": {"x": jnp.ones(3)}}, fp)
    with pytest.raises(ValueError, match="not a tree of numpy arrays"):
        tr.load_params_npz(jax_leaf)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    _, params = jax_params("resnet18", seed=3, size=32)
    path = tmp_path_factory.mktemp("weights") / "resnet18.pkl"
    jx.save_params_npz(params, path)
    return str(path)


@pytest.mark.parametrize("mode", ["host", "imagenet_norm", "resize_on_device"])
def test_patch_encoder_matches_jax(weights_file, mode):
    rng = np.random.default_rng(4)
    size = 64 if mode == "resize_on_device" else 32
    patches = rng.integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    kw = dict(batch_size=4, patch_size=32, weights=weights_file,
              imagenet_norm=mode == "imagenet_norm", resize_on_device=mode == "resize_on_device")
    want = jx.PatchEncoder("resnet18", **kw).encode_patches(patches)
    enc = tx.PatchEncoder("resnet18", device="cpu", **kw)
    got = enc.encode_patches(patches)
    assert got.shape == (6, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(enc.encode_patches(patches[:4]), got[:4])  # padding


def test_patch_encoder_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0 needs a CUDA device"):
        tx.PatchEncoder("resnet18", batch_size=2, patch_size=32)


def _coords():
    return [{"x": x, "y": y, "row": 0, "col": 0} for y in (0, 700, 1400) for x in (0, 900, 1980)]


def test_read_patches_thread_and_process_pools(tmp_path):
    img = blob_slide()
    slide = ImageSlide("s.png", image=img)
    jslide = JaxImageSlide("s.png", image=Image.fromarray(img))
    coords = _coords()
    got = tx._read_patches(slide, coords, 128, 64, num_workers=4).numpy()
    assert got.shape == (9, 64, 64, 3)
    np.testing.assert_array_equal(tx._read_patches(slide, coords, 128, 64, num_workers=1).numpy(),
                                  got)
    want = jx._read_patches(jslide, coords, 128, 64, num_workers=1)
    np.testing.assert_array_equal(got, want)
    raw = tx._read_patches(slide, coords, 128, 64, num_workers=4, resize_on_host=False).numpy()
    np.testing.assert_array_equal(raw, jx._read_patches(jslide, coords, 128, 64, num_workers=1,
                                                        resize_on_host=False))
    path = tmp_path / "s.png"
    Image.fromarray(img).save(path)
    with ProcessDecodePool(2) as pool:
        np.testing.assert_array_equal(pool.read_patches(str(path), coords, 128, 64), got)
        np.testing.assert_array_equal(
            pool.read_patches(str(path), coords, 128, 64, resize_on_host=False), raw)
        assert not any(f.result(timeout=60) for f in
                       [pool._pool.submit(torch.cuda.is_initialized) for _ in range(4)])


def test_extract_features_matches_jax(tmp_path, monkeypatch, weights_file):
    import importlib

    jt = importlib.import_module("murcl_tpu.preprocess.tiling")
    img = blob_slide()
    props = {"aperio.AppMag": "20"}
    jslide = JaxImageSlide("fake.png", image=Image.fromarray(img), properties=props)
    monkeypatch.setattr(jt, "open_slide", lambda _: jslide)
    monkeypatch.setattr(jx, "open_slide", lambda _: jslide)
    monkeypatch.setattr(tx, "open_slide", lambda _, **__: ImageSlide("fake.png", image=img,
                                                               properties=props))
    (tmp_path / "coord").mkdir()
    coord = jt.tiling("fake.png", magnification=10, patch_size=32, scale_factor=16,
                      coord_dir=tmp_path / "coord", filename="fake")
    assert coord["patch_size_level0"] == 64 and 50 < coord["num_patches"] < 600
    jx.extract_features(tmp_path, tmp_path / "jax", batch_size=64, num_workers=2,
                        weights=weights_file)
    records = tx.extract_features(tmp_path, tmp_path / "port", batch_size=64, num_workers=2,
                                  weights=weights_file, device="cpu")
    assert [r["num_patches"] for r in records] == [coord["num_patches"]]
    with np.load(tmp_path / "jax" / "fake.npz") as a, np.load(tmp_path / "port" / "fake.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("filename", "num_patches", "num_row", "num_col", "coords"):
            np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_allclose(b["img_features"], a["img_features"], rtol=1e-3, atol=1e-3)
    assert tx.extract_features(tmp_path, tmp_path / "port", device="cpu") == []  # npz exists


def test_patch_encoder_resizes_level0_crops_exactly(weights_file):
    """Given level-0 crops, the encoder resizes them with PIL's bicubic, bit
    for bit as ``resize_u8`` on the host: the card's extraction path
    (``resize_u8_torch`` in float64), run here on the CPU."""
    rng = np.random.default_rng(5)
    crops = rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    enc = tx.PatchEncoder("resnet18", batch_size=4, patch_size=32, weights=weights_file,
                          device="cpu")
    host = np.stack([resize_u8(c, (32, 32)) for c in crops])
    np.testing.assert_array_equal(enc.encode_patches(crops), enc.encode_patches(host))


def test_extract_features_in_chunks(tmp_path, monkeypatch, weights_file):
    """A slide read in chunks of ``READ_CHUNK`` patches gives the features of
    one read, and one record."""
    img = blob_slide()
    props = {"aperio.AppMag": "20"}
    monkeypatch.setattr(tx, "open_slide", lambda _, **__: ImageSlide("fake.png", image=img,
                                                               properties=props))
    coords = [{"x": x, "y": y, "row": i, "col": j} for i, y in enumerate(range(0, 1400, 100))
              for j, x in enumerate(range(0, 1900, 100))]
    (tmp_path / "coord").mkdir()
    dump_json({"slide_filepath": "fake.png", "patch_size": 32, "patch_size_level0": 64,
               "num_patches": len(coords), "num_row": 14, "num_col": 19, "coords": coords},
              tmp_path / "coord" / "fake.json")
    kw = dict(batch_size=32, num_workers=2, weights=weights_file, device="cpu")
    tx.extract_features(tmp_path, tmp_path / "one", **kw)
    monkeypatch.setattr(tx, "READ_CHUNK", 64)
    records = tx.extract_features(tmp_path, tmp_path / "chunks", **kw)
    assert [r["num_patches"] for r in records] == [len(coords)] and len(coords) > 4 * 64
    with np.load(tmp_path / "one" / "fake.npz") as a, \
            np.load(tmp_path / "chunks" / "fake.npz") as b:
        np.testing.assert_array_equal(b["img_features"], a["img_features"])
        np.testing.assert_array_equal(b["coords"], a["coords"])
