#!/usr/bin/env python
"""Per-slide k-means CLI of the PyTorch/CUDA port
(``wsi_processing/features_clustering.py``).

Run as ``python -m murcl_tpu_torch.features_clustering``; the same flags,
``--backend`` ``torch`` (the default) or ``sklearn``, and ``--device``, a
CUDA device index (the default ``0``) or ``cpu``, for the torch backend.
Writes ``<feat_dir>/k-means-<K>/<case_id>.{npz,json}`` in the data contract.
"""

import argparse
import time
from pathlib import Path

import numpy as np

from murcl_tpu_torch.data.contract import save_cluster_npz_json
from murcl_tpu_torch.drivers.murcl import resolve_device
from murcl_tpu_torch.preprocess.kmeans import kmeans


def run(args):
    """Returns, per slide clustered, ``{case_id, num_features, ms}``."""
    device = resolve_device(args.device) if args.backend == 'torch' else None
    save_dir = Path(args.feat_dir) / f'k-means-{args.num_clusters}'
    save_dir.mkdir(parents=True, exist_ok=True)
    feat_paths = sorted(Path(args.feat_dir).glob('*.npz'))
    records = []
    for i, feat_npz in enumerate(feat_paths):
        case_id = feat_npz.stem
        npz_filepath = save_dir / f'{case_id}.npz'
        json_filepath = save_dir / f'{case_id}.json'
        if npz_filepath.exists() and not args.exist_ok:
            print(f"{npz_filepath} exists!")
            continue
        with np.load(feat_npz) as z:
            feats = z['img_features']
        if feats.shape[0] < args.num_clusters:
            print(f"{case_id}: fewer features than clusters, skipping.")
            continue
        t0 = time.perf_counter()
        labels, _ = kmeans(feats, args.num_clusters, seed=args.seed, backend=args.backend,
                           device=device)
        ms = 1e3 * (time.perf_counter() - t0)
        save_cluster_npz_json(labels, args.num_clusters, npz_path=npz_filepath,
                              json_path=json_filepath)
        print(f"{i + 1:3}/{len(feat_paths):3} {case_id}: {feats.shape[0]} features -> "
              f"{args.num_clusters} clusters")
        records.append({"case_id": case_id, "num_features": int(feats.shape[0]), "ms": ms})
    return records


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--feat_dir', type=str, default='',
                        help="directory containing feature npz files")
    parser.add_argument('--num_clusters', type=int, default=10)
    parser.add_argument('--exist_ok', action='store_true', default=False)
    parser.add_argument('--seed', type=int, default=985)
    parser.add_argument('--backend', type=str, default='torch', choices=['torch', 'sklearn'])
    parser.add_argument('--device', default='0', help="cpu, N or cuda:N (torch backend)")
    return parser.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
