"""Host-side dataset view over the csv/npz contract: ``WSIDataset``
(counterpart of ``murcl_tpu/data/datasets.py:23-100``, reference
``utils/datasets.py:12``).

Training goes through :class:`murcl_tpu_torch.data.bank.FeatureBank`; this
class serves the full-slide heatmaps. The manifest rows come from
:func:`murcl_tpu_torch.data.contract.load_manifest` (csv, no pandas).
``WSIWithCluster``, ``ClusterFeatures`` and ``WSIPhenotype`` are not ported
yet (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from murcl_tpu_torch.data import contract


class WSIDataset:
    """Bag-of-patch-features dataset over the CSV manifest.

    Per item ``(features (N, D) float32, label int64, case_id)``, with
    optional uniform subsampling to ``num_sample_patches`` (indices sorted
    ascending) and optional zero-pad/truncate to that size (``fixed_size``).
    Sampling draws from ``rng``, an ``np.random.Generator``, or from numpy's
    global generator when it is None, as the JAX package does.
    """

    def __init__(self, data_csv, indices: Optional[Iterable[str]] = None,
                 num_sample_patches: Optional[int] = None, fixed_size: bool = False,
                 shuffle: bool = False, patch_random: bool = False, preload: bool = True,
                 rng: Optional[np.random.Generator] = None) -> None:
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
        feat = self.patch_features[case_id] if self.preload else self._load(case_id)
        feat = self.sample_feat(feat)
        if self.fixed_size:
            feat = self.fix_size(feat)
        return feat.astype(np.float32), np.int64(self.samples[case_id]["label"]), case_id

    def shuffle(self) -> None:
        random.shuffle(self.indices)

    def _load(self, case_id: str) -> np.ndarray:
        return contract.load_features_npz(self.samples[case_id]["features_filepath"])

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
