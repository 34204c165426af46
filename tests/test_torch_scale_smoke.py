"""The port of ``scripts/scale_smoke.py`` (``murcl_tpu_torch/scripts/scale_smoke.py``)
on the CPU, at a small size: 6 slides of 100-400 patches, batch 2, 2 steps.

It runs end to end with ``--device cpu`` (streaming sources, supervised
CLAM_SB stage-3 steps, the full-bag attention pass) and ends with ``SCALE
SMOKE OK``; its losses and scores are finite. The port's
``generate_synthetic_dataset`` takes the JAX one's ``signal`` and, at the
same seed, writes bitwise the JAX generator's features and clusters (at the
JAX default of 2.0 and at the script's 6.0). Without a card its default
device raises: no fallback.
"""

import json

import numpy as np
import pytest
import torch

from murcl_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
from murcl_tpu_torch.scripts import scale_smoke

SHAPE = (6, 100, 400, 2, 2)


def test_runs_on_cpu(tmp_path, capsys):
    res = scale_smoke.run("cpu", SHAPE, root=tmp_path / "scale")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SCALE SMOKE OK"
    assert any(line.startswith("stage-3 streaming train:") for line in out)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["attention_finite"] and 100 <= res["attention_n"] <= 400
    assert res["nmax"] >= res["attention_n"] and res["steps_per_s"] > 0


def test_split_shares():
    ids = [f"s{i}" for i in range(24)]
    assert [len(v) for v in scale_smoke.split_of(ids).values()] == [16, 4, 4]
    assert [len(v) for v in scale_smoke.split_of(ids[:6]).values()] == [4, 1, 1]


@pytest.mark.parametrize("signal", [None, 6.0])
def test_generator_signal_is_jax(tmp_path, signal):
    kw = dict(num_slides=4, dim=32, num_clusters=10, seed=985, min_patches=100,
              max_patches=400)
    if signal is not None:
        kw["signal"] = signal
    got = generate_synthetic_dataset(tmp_path / "port", **kw)
    want = jax_generate(tmp_path / "jax", **kw)
    assert got["case_ids"] == want["case_ids"]
    for case in got["case_ids"]:
        for sub, key in (("features", "img_features"), ("k-means-10", "features_cluster_indices")):
            a = np.load(tmp_path / "port" / sub / f"{case}.npz")[key]
            b = np.load(tmp_path / "jax" / sub / f"{case}.npz")[key]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        assert (json.loads((tmp_path / "port" / "k-means-10" / f"{case}.json").read_text())
                == json.loads((tmp_path / "jax" / "k-means-10" / f"{case}.json").read_text()))


def test_signal_moves_the_label_1_slides(tmp_path):
    kw = dict(num_slides=2, dim=32, num_clusters=10, seed=985, min_patches=100,
              max_patches=400)
    generate_synthetic_dataset(tmp_path / "a", **kw)
    generate_synthetic_dataset(tmp_path / "b", signal=6.0, **kw)
    feats = [[np.load(tmp_path / r / "features" / f"synt_00{i}.npz")["img_features"]
              for i in range(2)] for r in "ab"]
    np.testing.assert_array_equal(feats[0][0], feats[1][0])  # label 0: no shift
    assert not np.array_equal(feats[0][1], feats[1][1])


def test_default_device_is_the_card():
    args = scale_smoke.parse_args([])
    assert args.device == "cuda:0" and tuple(args.shape) == scale_smoke.SHAPE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scale_smoke.run()
