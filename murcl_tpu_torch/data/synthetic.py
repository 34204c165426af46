"""Synthetic dataset written in the on-disk contract, without pandas.

Counterpart of ``murcl_tpu/data/synthetic.py`` (``make_synthetic_slide``,
``generate_synthetic_dataset``): fake slides with random patch features,
class-dependent signal and clusters by construction. ``slide_patches``
fixes every slide's patch count (the benchmark shape); otherwise counts are
drawn from ``[min_patches, max_patches]``. :func:`synthetic_slide` draws
a slide image (tissue blobs and pen strokes on white) for the
preprocessing path.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from murcl_tpu_torch.data import contract
from murcl_tpu_torch.utils.general import dump_json


def make_synthetic_slide(rng: np.random.Generator, num_patches: int, dim: int,
                         num_clusters: int, label: int, signal: float = 2.0):
    """One fake slide: features ``(N, D)`` float32 + cluster labels ``(N,)``."""
    centroids = rng.normal(size=(num_clusters, dim)).astype(np.float32)
    assignment = rng.integers(0, num_clusters, size=num_patches)
    feats = centroids[assignment] + 0.3 * rng.normal(
        size=(num_patches, dim)).astype(np.float32)
    if label == 1:
        tumor_mask = assignment == int(rng.integers(0, num_clusters))
        feats[tumor_mask] += signal / np.sqrt(dim)
    return feats.astype(np.float32), assignment.astype(np.int64)


def generate_synthetic_dataset(root, num_slides: int = 8, dim: int = 64,
                               num_clusters: int = 5, min_patches: int = 60,
                               max_patches: int = 200, seed: int = 985,
                               splits: Optional[dict] = None,
                               slide_patches: Optional[int] = None) -> dict:
    """Write ``features/``, ``k-means-K/``, ``synthetic_{K}.csv`` and
    ``data_split.json`` under ``root``; return their paths."""
    root = Path(root)
    feat_dir = root / "features"
    cluster_dir = root / f"k-means-{num_clusters}"
    feat_dir.mkdir(parents=True, exist_ok=True)
    cluster_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    rows: List[dict] = []
    case_ids: List[str] = []
    for i in range(num_slides):
        case_id = f"synt_{i:03d}"
        label = i % 2
        n = slide_patches or int(rng.integers(min_patches, max_patches + 1))
        feats, assignment = make_synthetic_slide(rng, n, dim, num_clusters, label)
        side = int(np.ceil(np.sqrt(n)))
        coords = np.stack([np.arange(n) // side, np.arange(n) % side], axis=1)
        feat_path = feat_dir / f"{case_id}.npz"
        contract.save_features_npz(feat_path, case_id, num_row=side, num_col=side,
                                   img_features=feats, coords=coords.astype(np.int64))
        contract.save_cluster_npz_json(
            assignment, num_clusters,
            npz_path=cluster_dir / f"{case_id}.npz",
            json_path=cluster_dir / f"{case_id}.json")
        rows.append({
            "case_id": case_id,
            "features_filepath": str(feat_path),
            "label": label,
            "clusters_filepath": str(cluster_dir / f"{case_id}.npz"),
            "clusters_json_filepath": str(cluster_dir / f"{case_id}.json"),
        })
        case_ids.append(case_id)

    data_csv = root / f"synthetic_{num_clusters}.csv"
    contract.save_manifest(data_csv, rows)

    if splits is None:
        n_train = max(2, int(0.5 * num_slides))
        n_valid = max(1, int(0.25 * num_slides))
        splits = {
            "train": case_ids[:n_train],
            "valid": case_ids[n_train:n_train + n_valid],
            "test": case_ids[n_train + n_valid:] or case_ids[-2:],
        }
    split_path = root / "data_split.json"
    dump_json(splits, split_path)
    return {
        "data_csv": str(data_csv),
        "data_split_json": str(split_path),
        "feat_dir": str(feat_dir),
        "cluster_dir": str(cluster_dir),
        "case_ids": case_ids,
        "num_clusters": num_clusters,
        "dim": dim,
    }


def synthetic_slide(height: int, width: int, seed: int = 0, cell: int = 32) -> np.ndarray:
    """An ``(height, width, 3)`` uint8 RGB slide: white, with a few elliptic
    blobs of pink tissue texture (a 256-pixel random tile repeated) and red
    and blue pen strokes, drawn on a grid of ``cell`` pixels so that a
    gigapixel slide takes seconds; ``height`` and ``width`` are multiples of
    ``cell``."""
    rng = np.random.default_rng(seed)
    gh, gw = height // cell, width // cell
    yy, xx = np.mgrid[0:gh, 0:gw]
    tissue = np.zeros((gh, gw), dtype=bool)
    for _ in range(4):
        cy, cx = rng.uniform(0.2, 0.8) * gh, rng.uniform(0.2, 0.8) * gw
        ry, rx = rng.uniform(0.12, 0.3) * gh, rng.uniform(0.12, 0.3) * gw
        tissue |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    pen = np.zeros((gh, gw), dtype=np.uint8)  # 1 red, 2 blue
    for colour in (1, 2):
        row = int(rng.integers(gh // 10, gh - gh // 10))
        c0 = int(rng.integers(0, gw // 4))
        pen[row:row + max(gh // 40, 1), c0:c0 + gw // 2] = colour
    tile = np.stack([rng.integers(180, 230, (256, 256)), rng.integers(120, 170, (256, 256)),
                     rng.integers(160, 210, (256, 256))], axis=-1).astype(np.uint8)
    up = lambda m: np.repeat(np.repeat(m, cell, axis=0), cell, axis=1)  # noqa: E731
    img = np.where(up(tissue)[..., None], np.tile(tile, (-(-height // 256), -(-width // 256), 1))
                   [:height, :width], np.uint8(255))
    pens = up(pen)
    img[pens == 1] = (230, 30, 40)
    img[pens == 2] = (40, 50, 220)
    return img
