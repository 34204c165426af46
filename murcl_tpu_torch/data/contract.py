"""On-disk data contract (counterpart of ``murcl_tpu/data/contract.py``).

- CSV manifest with columns ``case_id, features_filepath, label,
  clusters_filepath, clusters_json_filepath``; the number of clusters K is
  the last ``_``-separated token of the CSV file stem.
- Features ``.npz`` with keys ``filename, num_patches, num_row, num_col,
  img_features (N, D), coords (N, 2)``.
- Cluster ``.npz`` with ``features_cluster_indices (N, 1)`` and a cluster
  ``.json`` holding K lists of patch indices.
- Split ``.json``: dict of case-id lists keyed ``train / valid / test``.
- Coord ``.json`` per slide, as tiling writes it: the slide's path,
  magnifications, grid and patch sizes, and the kept patches' ``row, col,
  x, y``.

The manifest is read with :mod:`csv`, not pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from murcl_tpu_torch.utils.general import dump_json, load_json

MANIFEST_COLUMNS = [
    "case_id",
    "features_filepath",
    "label",
    "clusters_filepath",
    "clusters_json_filepath",
]


def num_clusters_from_csv(data_csv) -> int:
    """Parse K from the manifest filename, e.g. ``camelyon16_10.csv`` -> 10."""
    return int(Path(data_csv).stem.split("_")[-1])


def load_manifest(data_csv, indices: Optional[Sequence[str]] = None) -> List[dict]:
    """Manifest rows as dicts, in file order or in the order of ``indices``.

    An unknown case id in ``indices`` raises ``KeyError``.
    """
    with open(data_csv, newline="", encoding="utf-8") as fp:
        rows = list(csv.DictReader(fp))
    if indices is None:
        return rows
    by_id = {r["case_id"]: r for r in rows}
    return [by_id[str(i)] for i in indices]


def save_manifest(data_csv, rows: Sequence[dict]) -> None:
    with open(data_csv, "w", newline="", encoding="utf-8") as fp:
        writer = csv.DictWriter(fp, fieldnames=MANIFEST_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)


def load_features_npz(path) -> np.ndarray:
    """Load ``img_features`` from a feature npz: float32 array ``(N, D)``."""
    with np.load(path) as z:
        return np.asarray(z["img_features"], dtype=np.float32)


def save_features_npz(path, filename: str, num_row: int, num_col: int,
                      img_features: np.ndarray, coords: np.ndarray) -> None:
    """Write a feature npz with the exact reference key set."""
    np.savez(
        file=path,
        filename=filename,
        num_patches=img_features.shape[0],
        num_row=num_row,
        num_col=num_col,
        img_features=img_features,
        coords=coords,
    )


def load_cluster_json(path) -> List[List[int]]:
    """Load the inverted cluster index: a list of K lists of patch indices."""
    return load_json(path)


def save_cluster_npz_json(labels: np.ndarray, num_clusters: int,
                          npz_path=None, json_path=None) -> List[List[int]]:
    """Write the ``(N, 1)`` label npz and the inverted-index json."""
    labels = np.asarray(labels).reshape(-1)
    if npz_path is not None:
        np.savez(file=npz_path, features_cluster_indices=labels[:, None])
    inverted: List[List[int]] = [[] for _ in range(num_clusters)]
    for patch_idx, cluster_idx in enumerate(labels):
        inverted[int(cluster_idx)].append(patch_idx)
    if json_path is not None:
        dump_json(inverted, json_path)
    return inverted


def load_split(path) -> Dict[str, List[str]]:
    """Load the split json (keys ``train/valid/test``, optionally more)."""
    return load_json(path)


def save_coord_json(path, slide_filepath: str, magnification: int,
                    magnification_level0: int, num_row: int, num_col: int,
                    patch_size: int, patch_size_level0: int,
                    coords: List[dict]) -> None:
    """Write a per-slide coord json (``wsi_processing/create_patches.py:108-121``)."""
    dump_json(
        {
            "slide_filepath": str(slide_filepath),
            "magnification": magnification,
            "magnification_level0": magnification_level0,
            "num_row": num_row,
            "num_col": num_col,
            "patch_size": patch_size,
            "patch_size_level0": patch_size_level0,
            "num_patches": len(coords),
            "coords": coords,
        },
        path,
    )
