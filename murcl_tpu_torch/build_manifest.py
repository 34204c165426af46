#!/usr/bin/env python
"""Build the training manifest CSV + split JSON from preprocessing output
(counterpart of ``scripts/build_manifest.py``, with the ``csv`` module in
place of pandas, which the card's machine lacks).

Run as ``python -m murcl_tpu_torch.build_manifest``; the same flags,
outputs, messages and exit codes. Given the feature and cluster dirs
written by ``murcl_tpu_torch.{extract_features,features_clustering}`` and a
labels CSV (``case_id,label``), it writes

- ``<out_dir>/<dataset>_<K>.csv``: ``case_id, features_filepath, label,
  clusters_filepath, clusters_json_filepath``, the bytes pandas'
  ``to_csv(index=False)`` writes (``\\n`` line ends); the trainers parse K
  from the name's last ``_`` token;
- ``<out_dir>/<dataset>_split.json``: ``{train, valid, test}`` case-id
  lists, stratified by label at ``--frac``: the labels in sorted order as
  ``groupby`` visits them, each group's ids in file order shuffled by
  ``np.random.default_rng(seed)``, counts ``max(1, round(n * frac))``.

Slides missing any artifact are reported and skipped. One difference is
kept on purpose: pandas reads a numeric-looking ``case_id`` such as
``001`` as the integer 1, so the script looks for ``1.npz``; the port keeps
the string ``001``.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path

COLUMNS = ["case_id", "features_filepath", "label", "clusters_filepath",
           "clusters_json_filepath"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--feat_dir", required=True,
                    help="dir of per-slide feature .npz "
                         "(murcl_tpu_torch.extract_features --save_dir)")
    ap.add_argument("--cluster_dir", required=True,
                    help="dir of per-slide cluster .npz/.json "
                         "(murcl_tpu_torch.features_clustering output)")
    ap.add_argument("--labels_csv", required=True,
                    help="CSV with case_id,label columns (header required)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--dataset", default="camelyon16")
    ap.add_argument("--num_clusters", type=int, default=10,
                    help="K — must match features_clustering; becomes "
                         "the manifest filename suffix the loaders parse")
    ap.add_argument("--frac", type=str, default="0.6,0.15,0.25",
                    help="train,valid,test fractions (label-stratified)")
    ap.add_argument("--seed", type=int, default=985)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    with open(args.labels_csv, newline="") as fp:
        reader = csv.DictReader(fp)
        columns = reader.fieldnames or []
        records = list(reader)
    if not {"case_id", "label"} <= set(columns):
        print(f"labels CSV needs case_id,label columns, got "
              f"{list(columns)}", file=sys.stderr)
        return 2

    feat_dir, clus_dir = Path(args.feat_dir), Path(args.cluster_dir)
    rows, skipped = [], []
    for rec in records:
        cid = rec["case_id"]
        feat = feat_dir / f"{cid}.npz"
        cnpz = clus_dir / f"{cid}.npz"
        cjson = clus_dir / f"{cid}.json"
        if not (feat.exists() and cnpz.exists() and cjson.exists()):
            missing = [p.name for p in (feat, cnpz, cjson)
                       if not p.exists()]
            skipped.append((cid, missing))
            continue
        rows.append(dict(case_id=cid, features_filepath=str(feat),
                         label=int(float(rec["label"])),
                         clusters_filepath=str(cnpz),
                         clusters_json_filepath=str(cjson)))
    if skipped:
        for cid, missing in skipped:
            print(f"skip {cid}: missing {', '.join(missing)}",
                  file=sys.stderr)
    if not rows:
        print("no slide has all three artifacts — ran the preprocessing "
              "CLIs first?", file=sys.stderr)
        return 2

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f"{args.dataset}_{args.num_clusters}.csv"
    with open(csv_path, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")  # pandas' line end, not csv's \r\n
        writer.writerow(COLUMNS)
        writer.writerows([r[c] for c in COLUMNS] for r in rows)

    fr = [float(x) for x in args.frac.split(",")]
    if not (len(fr) == 3 and abs(sum(fr) - 1.0) < 1e-6):
        raise AssertionError("--frac must be three fractions summing to 1")
    rng = np.random.default_rng(args.seed)
    split = {"train": [], "valid": [], "test": []}
    for label in sorted({r["label"] for r in rows}):  # groupby's order
        ids = [r["case_id"] for r in rows if r["label"] == label]
        rng.shuffle(ids)
        n = len(ids)
        n_tr = max(1, round(n * fr[0]))
        n_va = max(1, round(n * fr[1]))
        split["train"] += ids[:n_tr]
        split["valid"] += ids[n_tr:n_tr + n_va]
        split["test"] += ids[n_tr + n_va:]
    for name, ids in split.items():
        if not ids:
            print(f"WARNING: {name} split is empty (too few slides for "
                  f"--frac {args.frac})", file=sys.stderr)
    split_path = out_dir / f"{args.dataset}_split.json"
    split_path.write_text(json.dumps(split, indent=2))

    print(json.dumps({
        "data_csv": str(csv_path), "data_split_json": str(split_path),
        "slides": len(rows), "skipped": len(skipped),
        "split_sizes": {k: len(v) for k, v in split.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
