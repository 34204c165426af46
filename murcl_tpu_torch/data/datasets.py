"""Host-side dataset views over the csv/npz/json contract (counterparts of
``murcl_tpu/data/datasets.py``; reference ``utils/datasets.py``):
``WSIDataset`` (``:12``), ``WSIWithCluster`` (``:115``), ``ClusterFeatures``
(``:168``) and ``WSIPhenotype`` (``:210``), with the same constructor
arguments and per-item tuples (numpy arrays), plus ``rng``.

Training goes through :class:`murcl_tpu_torch.data.bank.FeatureBank`; these
classes serve the full-slide heatmaps, loading the preprocessing's output,
and users porting reference code. The manifest rows come from
:func:`murcl_tpu_torch.data.contract.load_manifest` (csv, no pandas).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from murcl_tpu_torch.data import contract


class WSIDataset:
    """Bag-of-patch-features dataset over the CSV manifest.

    Per item ``(features (N, D) float32, label int64, case_id)``, with
    optional uniform subsampling to ``num_sample_patches`` (indices sorted
    ascending) and optional zero-pad/truncate to that size (``fixed_size``).
    Sampling draws from ``rng`` (an ``np.random.RandomState``, whose draws
    equal numpy's global stream after the same seed, or an
    ``np.random.Generator``), or from numpy's global generator when it is
    None, as the JAX package does.
    """

    def __init__(self, data_csv, indices: Optional[Iterable[str]] = None,
                 num_sample_patches: Optional[int] = None, fixed_size: bool = False,
                 shuffle: bool = False, patch_random: bool = False, preload: bool = True,
                 rng=None) -> None:
        self.data_csv = data_csv
        self.num_sample_patches = num_sample_patches
        self.fixed_size = fixed_size
        self.patch_random = patch_random
        self.preload = preload
        self.rng = rng

        rows = contract.load_manifest(data_csv, None if indices is None else list(indices))
        self.samples: Dict[str, dict] = {r["case_id"]: r for r in rows}
        self.indices = [r["case_id"] for r in rows]
        if shuffle:
            self.shuffle()
        self.patch_dim = int(contract.load_features_npz(rows[0]["features_filepath"]).shape[-1])
        if self.preload:
            self.patch_features = {c: self._load(c) for c in self.indices}

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.int64, str]:
        case_id = self.indices[index]
        feat = self.sample_feat(self._features_of(case_id))
        if self.fixed_size:
            feat = self.fix_size(feat)
        return feat.astype(np.float32), np.int64(self.samples[case_id]["label"]), case_id

    def shuffle(self) -> None:
        random.shuffle(self.indices)

    def _load(self, case_id: str) -> np.ndarray:
        return contract.load_features_npz(self.samples[case_id]["features_filepath"])

    def _features_of(self, case_id: str) -> np.ndarray:
        return self.patch_features[case_id] if self.preload else self._load(case_id)

    def sample_feat(self, feat: np.ndarray) -> np.ndarray:
        rng = np.random if self.rng is None else self.rng
        num_patches = feat.shape[0]
        if self.num_sample_patches is not None and num_patches > self.num_sample_patches:
            sample = rng.choice(num_patches, size=self.num_sample_patches, replace=False)
            feat = feat[sorted(sample)]
        if self.patch_random:
            rng.shuffle(feat)
        return feat

    def fix_size(self, feat: np.ndarray) -> np.ndarray:
        if feat.shape[0] < self.num_sample_patches:
            pad = np.zeros((self.num_sample_patches - feat.shape[0], self.patch_dim))
            return np.concatenate((feat, pad))
        return feat[: self.num_sample_patches]


class WSIWithCluster(WSIDataset):
    """Adds the per-slide cluster inverted index; K parsed from the CSV name.
    Per item ``(features, clusters (K lists of patch indices), label,
    case_id)``."""

    def __init__(self, data_csv, indices: Optional[Iterable[str]] = None,
                 num_sample_patches: Optional[int] = None, fixed_size: bool = False,
                 shuffle: bool = False, patch_random: bool = False, preload: bool = True,
                 rng=None) -> None:
        super().__init__(data_csv, indices, num_sample_patches, fixed_size, shuffle,
                         patch_random, preload, rng)
        self.num_clusters = contract.num_clusters_from_csv(data_csv)
        if self.preload:
            self.cluster_indices = {c: self._load_clusters(c) for c in self.indices}

    def __getitem__(self, index: int):
        case_id = self.indices[index]
        return (self._features_of(case_id).astype(np.float32), self._clusters_of(case_id),
                np.int64(self.samples[case_id]["label"]), case_id)

    def _load_clusters(self, case_id: str) -> List[List[int]]:
        return contract.load_cluster_json(self.samples[case_id]["clusters_json_filepath"])

    def _clusters_of(self, case_id: str) -> List[List[int]]:
        return self.cluster_indices[case_id] if self.preload else self._load_clusters(case_id)


class ClusterFeatures(WSIWithCluster):
    """Cluster-stratified sampling (``utils/datasets.py:168-207``): each
    cluster keeps ``rint(n_c * num_sample_patches / N)`` of its patches.
    Per item ``(features, label, case_id)``."""

    def __getitem__(self, index: int):
        case_id = self.indices[index]
        feat = self.sample_by_cluster(self._features_of(case_id), self._clusters_of(case_id))
        if self.fixed_size:
            feat = self.fix_size(feat)
        return feat.astype(np.float32), np.int64(self.samples[case_id]["label"]), case_id

    def sample_by_cluster(self, feat: np.ndarray, clusters: List[List[int]]) -> np.ndarray:
        rng = np.random if self.rng is None else self.rng
        ratio = 1.0 if self.num_sample_patches is None else self.num_sample_patches / feat.shape[0]
        if ratio < 1:
            sample_indices: List[int] = []
            for c in range(self.num_clusters):
                n_c = len(clusters[c])
                sample = rng.choice(n_c, size=int(np.rint(n_c * ratio)), replace=False)
                sample_indices.extend(clusters[c][s] for s in sample)
            feat = feat[sorted(sample_indices)]
        if self.patch_random:
            rng.shuffle(feat)
        return feat


class WSIPhenotype(ClusterFeatures):
    """Features grouped by cluster: per item ``(phenotype (K arrays of (D, 1,
    n_c)), mask (K,) with 0 for an empty cluster, label, case_id)``."""

    def __getitem__(self, index: int):
        case_id = self.indices[index]
        phenotype, mask = self.create_phenotype(self._features_of(case_id),
                                                self._clusters_of(case_id))
        return phenotype, mask, np.int64(self.samples[case_id]["label"]), case_id

    def create_phenotype(self, feat: np.ndarray, clusters: List[List[int]]):
        rng = np.random if self.rng is None else self.rng
        ratio = 1.0 if self.num_sample_patches is None else self.num_sample_patches / feat.shape[0]
        phenotype: List[np.ndarray] = []
        mask = np.ones(self.num_clusters, dtype=np.float32)
        for k in range(self.num_clusters):
            if len(clusters[k]) == 0:
                cluster_feat = np.zeros((1, self.patch_dim), dtype=np.float32)
                mask[k] = 0
            else:
                if ratio < 1:
                    size = int(np.rint(len(clusters[k]) * ratio))
                    sample = sorted(rng.choice(len(clusters[k]), size=size, replace=False))
                    idx = [clusters[k][i] for i in sample]
                else:
                    idx = list(clusters[k])
                if self.patch_random:
                    rng.shuffle(idx)
                cluster_feat = feat[idx]
            phenotype.append(np.expand_dims(np.swapaxes(cluster_feat, 1, 0), 1))
        return phenotype, mask
