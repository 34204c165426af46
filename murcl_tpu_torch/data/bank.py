"""Device-resident feature bank (counterpart of ``murcl_tpu/data/bank.py``).

The whole split's patch features live on the device as one ``(P, D)``
tensor; per-slide metadata are stacked tensors, so sub-bag selection
(:mod:`murcl_tpu_torch.ops.select`) and compaction
(:mod:`murcl_tpu_torch.ops.compact`) run on the device and the only
host->device traffic per step is a ``(B,)`` vector of slide ids.

Unlike the JAX bank, slides are packed back to back: the compaction kernel
copies bank row ``offset + p`` only for ``p < num_patches``, so it needs
neither the 8-row-aligned offsets nor the ``Nmax`` zero rows past the last
slide that the TPU kernel's fixed-size DMA window needed. ``max_patches`` is
the largest slide's patch count, unpadded.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from murcl_tpu_torch.data import contract


def _patch_cluster_pos(cluster_lists: List[List[int]], n_max: int):
    """Per-patch inverse of the cluster lists: ``(cluster_id, pos)``.

    ``pos`` is the patch's position within its cluster's (k-means-order)
    index list; padding rows carry ``pos = -1`` and are never selected.
    Clusters must be disjoint and duplicate-free, as k-means output is.
    """
    cid = np.zeros((n_max,), np.int32)
    pos = np.full((n_max,), -1, np.int32)
    for k, cluster in enumerate(cluster_lists):
        if not cluster:
            continue
        idxs = np.asarray(cluster, dtype=np.int64)
        if np.unique(idxs).size != idxs.size:
            raise ValueError(
                f"cluster {k} lists the same patch more than once; sub-bag "
                "selection requires disjoint, duplicate-free clusters")
        if np.any(pos[idxs] >= 0):
            raise ValueError(
                f"cluster lists overlap (patch appears in cluster {k} and an "
                "earlier one); sub-bag selection requires disjoint clusters")
        cid[idxs] = k
        pos[idxs] = np.arange(len(cluster), dtype=np.int32)
    return cid, pos


@dataclass
class FeatureBank:
    """All patch features of a split plus per-slide metadata, as tensors.

    - ``feats``:         ``(P, D)`` float32 (or the dtype given to :meth:`to`)
    - ``offsets``:       ``(S,)``   int64, first bank row of each slide
    - ``num_patches``:   ``(S,)``   int64
    - ``cluster_sizes``: ``(S, K)`` int64
    - ``patch_cluster``: ``(S, Nmax)`` int64, cluster id of each patch
    - ``patch_pos``:     ``(S, Nmax)`` int64, position in that cluster, -1 pad
    - ``labels``:        ``(S,)``   int64
    """

    feats: torch.Tensor
    offsets: torch.Tensor
    num_patches: torch.Tensor
    cluster_sizes: torch.Tensor
    patch_cluster: torch.Tensor
    patch_pos: torch.Tensor
    labels: torch.Tensor
    case_ids: List[str] = field(default_factory=list)
    num_clusters: int = 0
    max_patches: int = 0

    @property
    def num_slides(self) -> int:
        return len(self.case_ids)

    @property
    def patch_dim(self) -> int:
        return int(self.feats.shape[-1])

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "FeatureBank":
        """Copy onto ``device``; ``dtype`` casts the features only."""
        return replace(
            self,
            feats=self.feats.to(device=device, dtype=dtype or self.feats.dtype),
            offsets=self.offsets.to(device),
            num_patches=self.num_patches.to(device),
            cluster_sizes=self.cluster_sizes.to(device),
            patch_cluster=self.patch_cluster.to(device),
            patch_pos=self.patch_pos.to(device),
            labels=self.labels.to(device),
        )


def bank_from_arrays(
    feats_per_slide: Sequence[np.ndarray],
    cluster_lists_per_slide: Sequence[List[List[int]]],
    labels: Sequence[int],
    case_ids: Optional[Sequence[str]] = None,
) -> FeatureBank:
    """Build a bank from in-memory arrays (tests, synthetic data)."""
    if not len(feats_per_slide):
        raise ValueError("empty slide list")
    num_clusters = len(cluster_lists_per_slide[0])
    s = len(feats_per_slide)
    case_ids = list(case_ids) if case_ids is not None else [f"case_{i}" for i in range(s)]
    counts = [int(f.shape[0]) for f in feats_per_slide]
    n_max = max(counts)

    sizes = np.zeros((s, num_clusters), dtype=np.int64)
    pcid = np.zeros((s, n_max), dtype=np.int64)
    ppos = np.full((s, n_max), -1, dtype=np.int64)
    for i, clusters in enumerate(cluster_lists_per_slide):
        if len(clusters) != num_clusters:
            raise ValueError(
                f"{case_ids[i]}: {len(clusters)} clusters, expected {num_clusters}")
        sizes[i] = [len(c) for c in clusters]
        pcid[i], ppos[i] = _patch_cluster_pos(clusters, n_max)

    feats = np.concatenate([np.asarray(f, np.float32) for f in feats_per_slide])
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return FeatureBank(
        feats=torch.from_numpy(feats),
        offsets=torch.as_tensor(offsets, dtype=torch.int64),
        num_patches=torch.as_tensor(counts, dtype=torch.int64),
        cluster_sizes=torch.from_numpy(sizes),
        patch_cluster=torch.from_numpy(pcid),
        patch_pos=torch.from_numpy(ppos),
        labels=torch.as_tensor(list(labels), dtype=torch.int64),
        case_ids=case_ids,
        num_clusters=num_clusters,
        max_patches=n_max,
    )


def build_bank(data_csv, indices: Optional[Sequence[str]] = None,
               num_clusters: Optional[int] = None) -> FeatureBank:
    """Build a :class:`FeatureBank` from a reference-contract CSV manifest.

    ``indices`` selects case ids (a split); ``num_clusters`` defaults to the
    count parsed from the CSV filename.
    """
    if num_clusters is None:
        num_clusters = contract.num_clusters_from_csv(data_csv)
    rows = contract.load_manifest(data_csv, indices)
    if not rows:
        raise ValueError(f"empty manifest selection for {data_csv}")
    feats, clusters, labels, case_ids = [], [], [], []
    for row in rows:
        cl = contract.load_cluster_json(row["clusters_json_filepath"])
        if len(cl) != num_clusters:
            raise ValueError(
                f"{row['case_id']}: cluster json has {len(cl)} clusters, "
                f"expected {num_clusters}")
        feats.append(contract.load_features_npz(row["features_filepath"]))
        clusters.append(cl)
        labels.append(int(row["label"]))
        case_ids.append(str(row["case_id"]))
    return bank_from_arrays(feats, clusters, labels, case_ids)
