"""The port's k-means against scikit-learn and the JAX package, and its
cluster-aware datasets against the JAX classes.

scikit-learn's and JAX's random streams are not the port's, so:
- Lloyd's iterations from injected centres equal ``sklearn.cluster.KMeans(
  init=centres, n_init=1, algorithm="lloyd")``: the same labels and
  iteration count, centres within 1e-5;
- ``kmeans`` recovers the three blobs of ``tests/test_preprocess.py:325-338``,
  and its inertia is at most 1.05x scikit-learn's (the JAX package's own
  bound, ``:341-357``);
- the cluster files equal ``save_cluster_npz_json``'s of the JAX package.

``WSIWithCluster``, ``ClusterFeatures`` and ``WSIPhenotype`` return what the
JAX classes return, draw for draw: the port's ``np.random.RandomState(s)``
against numpy's global stream after ``np.random.seed(s)``.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from murcl_tpu.data import contract as jax_contract
from murcl_tpu.data.datasets import ClusterFeatures as JaxClusterFeatures
from murcl_tpu.data.datasets import WSIPhenotype as JaxWSIPhenotype
from murcl_tpu.data.datasets import WSIWithCluster as JaxWSIWithCluster
from murcl_tpu_torch.data.datasets import ClusterFeatures, WSIPhenotype, WSIWithCluster
from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
from murcl_tpu_torch.features_clustering import main as clustering_main
from murcl_tpu_torch.preprocess.kmeans import kmeans, kmeans_torch, lloyd


def _blobs(rng, k, n, d, spread=3.0):
    return np.concatenate([rng.normal(size=(n, d)).astype(np.float32)
                           + spread * rng.normal(size=(1, d)).astype(np.float32)
                           for _ in range(k)])


@pytest.mark.parametrize("k, n, d", [(6, 300, 16), (10, 80, 64), (3, 500, 2)])
def test_lloyd_from_injected_centres_equals_sklearn(k, n, d):
    rng = np.random.default_rng(k)
    x = _blobs(rng, k, n, d)
    init = x[rng.choice(len(x), k, replace=False)]
    sk = KMeans(n_clusters=k, init=init, n_init=1, algorithm="lloyd").fit(x)
    tol = 1e-4 * float(x.var(axis=0).mean())
    centers, labels, inertia, iters = lloyd(torch.from_numpy(x), torch.from_numpy(init)[None],
                                            300, tol)
    np.testing.assert_array_equal(labels[0].numpy(), sk.labels_)
    np.testing.assert_allclose(centers[0].numpy(), sk.cluster_centers_, atol=1e-5)
    assert int(iters[0]) == sk.n_iter_
    np.testing.assert_allclose(float(inertia[0]), sk.inertia_, rtol=1e-4)


def test_kmeans_recovers_blobs():
    rng = np.random.default_rng(0)
    centers = np.array([[0, 0], [10, 0], [0, 10]], dtype=np.float32)
    x = np.concatenate([c + 0.3 * rng.normal(size=(50, 2)).astype(np.float32) for c in centers])
    labels, learned = kmeans(x, 3, seed=0, n_init=4)
    assert labels.shape == (150,) and labels.dtype == np.int64 and learned.shape == (3, 2)
    for i in range(3):
        blk = labels[i * 50:(i + 1) * 50]
        assert (blk == blk[0]).all()
    assert len(set(labels[::50])) == 3


@pytest.mark.parametrize("n, d, k", [(200, 8, 5), (1000, 64, 10)])
def test_kmeans_inertia_within_sklearn_bound(n, d, k):
    x = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    labels, centers = kmeans(x, k, seed=985, n_init=10)
    ours = float(((x - centers[labels]) ** 2).sum())
    theirs = KMeans(n_clusters=k, random_state=985, n_init=10).fit(x).inertia_
    assert ours <= theirs * 1.05, (ours, theirs)
    out = kmeans_torch(torch.from_numpy(x), k)
    np.testing.assert_allclose(out["inertia"], ours, rtol=1e-4)
    assert 1 <= out["iterations"] <= 300
    np.testing.assert_array_equal(kmeans(x, k, seed=985)[0], labels)  # seeded: the same


def test_kmeans_backends():
    x = np.random.default_rng(2).normal(size=(60, 4)).astype(np.float32)
    labels, centers = kmeans(x, 3, backend="sklearn")
    sk = KMeans(n_clusters=3, random_state=985, n_init=10).fit(x)
    np.testing.assert_array_equal(labels, sk.labels_)
    with pytest.raises(ValueError, match="backend"):
        kmeans(x, 3, backend="jax")
    # every point a duplicate of one: no D^2 weight left, k-means++ draws uniformly
    same = np.ones((20, 3), np.float32)
    labels, centers = kmeans(same, 4, n_init=2)
    assert (centers == 1).all() and labels.shape == (20,)


def test_cli_cluster_files_equal_jax_contract(tmp_path):
    rng = np.random.default_rng(3)
    for i, n in enumerate((120, 7, 300)):
        jax_contract.save_features_npz(tmp_path / f"s{i}.npz", f"s{i}", 4, 5,
                                       _blobs(rng, 4, n // 4 + 1, 16)[:n],
                                       np.zeros((n, 2), np.int64))
    records = clustering_main(["--feat_dir", str(tmp_path), "--num_clusters", "10",
                               "--device", "cpu"])
    assert [r["case_id"] for r in records] == ["s0", "s2"]  # s1: fewer features than K
    out, ref = tmp_path / "k-means-10", tmp_path / "jax"
    ref.mkdir()
    for case in ("s0", "s2"):
        with np.load(out / f"{case}.npz") as z:
            labels = z["features_cluster_indices"]
        want = jax_contract.save_cluster_npz_json(labels, 10, npz_path=ref / "w.npz",
                                                  json_path=ref / "w.json")
        assert json.loads((out / f"{case}.json").read_text()) == want
        assert (out / f"{case}.json").read_bytes() == (ref / "w.json").read_bytes()
        with np.load(ref / "w.npz") as z:
            np.testing.assert_array_equal(z["features_cluster_indices"], labels)
        assert labels.shape[1] == 1
    assert clustering_main(["--feat_dir", str(tmp_path), "--num_clusters", "10",
                            "--device", "cpu"]) == []  # existing files skipped


@pytest.fixture(scope="module")
def cluster_dataset(tmp_path_factory):
    return generate_synthetic_dataset(tmp_path_factory.mktemp("clusters"), num_slides=3, dim=8,
                                      num_clusters=4, min_patches=20, max_patches=40)


KWARGS = (dict(), dict(num_sample_patches=16, patch_random=True),
          dict(num_sample_patches=12, fixed_size=True, preload=False),
          dict(num_sample_patches=100, fixed_size=True))


def _items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("ours_cls, theirs_cls", [(WSIWithCluster, JaxWSIWithCluster),
                                                  (ClusterFeatures, JaxClusterFeatures),
                                                  (WSIPhenotype, JaxWSIPhenotype)])
def test_cluster_datasets_match_jax_draw_for_draw(cluster_dataset, ours_cls, theirs_cls):
    csv = cluster_dataset["data_csv"]
    for kw in KWARGS:
        theirs = theirs_cls(csv, **kw)
        assert theirs.num_clusters == 4
        for seed in (0, 1):
            ours = ours_cls(csv, rng=np.random.RandomState(seed), **kw)
            assert len(ours) == 3 and ours.num_clusters == 4 and ours.patch_dim == 8
            np.random.seed(seed)
            for i in range(3):  # one stream over the items, as a loader reads them
                _items_equal(ours[i], theirs[i])
