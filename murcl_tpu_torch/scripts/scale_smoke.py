"""TCGA-scale smoke: variable bags of 1,000-10,000 patches.
(Counterpart of ``scripts/scale_smoke.py``.)

Writes 24 synthetic slides of 1,000-10,000 patches (D 512, K 10, seed 985,
``signal`` 6.0), split 16 / 4 / 4, and builds streaming sources over them
(``build_sources(..., streaming=True)``: each batch's slides staged onto the
device). Then 6 supervised stage-3 steps at batch 8 (CLAM_SB gated, dropout
0.25, subtyping, 2 classes; the GRU head at hidden 1024; ``PPO(hidden 512,
action 10, gamma 0.1, K_epochs 3, action_std 0.5)``; T 6, feat_size 1024,
bf16, Adam at 1e-4) on slide ids drawn by ``np.random.default_rng(0)``, the
first the warm-up, and the steps/s of the other 5; then a full-bag
attention pass over the largest slide (``AttentionScorer(512, 2, bucket
2048)``: past 6 MiB the pool streams through K8), its seconds and whether
every score is finite. Each step draws from a CPU ``torch.Generator`` seeded
with its index, as the JAX script keys its steps. It exercises the
streaming mini-bank at a large Nmax, selection over big ragged clusters and
the full-bag pool. (The JAX script's docstring names a whole-split
evaluation that its code does not run; neither does this.)

``--shape SLIDES MIN MAX BATCH STEPS`` sizes the run; ``--device cpu`` runs
the plain twins; the slides go to a temporary directory (``--root`` to keep
them), removed after.

    python -m murcl_tpu_torch.scripts.scale_smoke              # cuda:0
    python -m murcl_tpu_torch.scripts.scale_smoke --device cpu --shape 6 100 400 2 2
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from murcl_tpu_torch.data.contract import load_features_npz, load_manifest
from murcl_tpu_torch.data.sources import build_sources
from murcl_tpu_torch.data.streaming import npy_member_span
from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.models import PPO, FullLayer, build_aggregator
from murcl_tpu_torch.preprocess.heatmaps import AttentionScorer
from murcl_tpu_torch.scripts.probes import probe_device, where

SHAPE = (24, 1000, 10000, 8, 6)  # slides, fewest and most patches, batch, steps
D, K, T, FEAT = 512, 10, 6, 1024


def split_of(case_ids) -> dict:
    """The JAX script's 16 / 4 / 4 of 24 slides, as shares of any count:
    two thirds train, a sixth valid, the rest test (one each at least)."""
    n = len(case_ids)
    n_train, n_valid = max(1, 2 * n // 3), max(1, n // 6)
    return {"train": case_ids[:n_train], "valid": case_ids[n_train:n_train + n_valid],
            "test": case_ids[n_train + n_valid:]}


def run(device="cuda:0", shape=SHAPE, root=None) -> dict:
    """Prints the JAX script's lines, ending ``SCALE SMOKE OK``; returns
    ``{"losses", "steps_per_s", "nmax", "attention_s", "attention_n",
    "attention_finite"}``."""
    dev = probe_device(device)
    slides, lo, hi, b, steps = shape
    tmp = None
    if root is None:
        root = tmp = tempfile.mkdtemp(prefix="scale_")
    try:
        ds = generate_synthetic_dataset(root, num_slides=slides, dim=D, num_clusters=K,
                                        seed=985, min_patches=lo, max_patches=hi, signal=6.0)
        split = split_of(ds["case_ids"])
        t0 = time.perf_counter()
        sources = build_sources(ds["data_csv"], split, streaming=True, device=dev,
                                dtype=torch.bfloat16)
        src = sources["train"]
        print(f"streaming sources built in {time.perf_counter() - t0:.1f}s; "
              f"Nmax={src.max_patches}, dim={src.patch_dim} ({where(dev)})", flush=True)

        torch.manual_seed(0)
        model, feature_num = build_aggregator("CLAM_SB", dim_in=D, num_classes=2,
                                              arch_setting={"dropout": 0.25, "subtyping": True})
        model.to(dev)
        fc = FullLayer(feature_num=feature_num, hidden_state_dim=1024, class_num=2).to(dev)
        ppo = PPO(state_dim=feature_num, hidden_state_dim=512, action_size=K, gamma=0.1,
                  K_epochs=3, action_std=0.5).to(dev)
        cfg = RolloutConfig(arch="CLAM_SB", T=T, feat_size=FEAT, num_clusters=K, train_stage=3,
                            compute_dtype="bfloat16")
        opt = torch.optim.Adam([*model.parameters(), *fc.parameters()], lr=1e-4)
        engine = SupervisedEngine(cfg, model, fc, ppo=ppo, optimizer=opt)

        np_rng = np.random.default_rng(0)
        losses, t0 = [], None
        for i in range(steps):
            ids = np_rng.choice(src.num_slides, b, replace=False)
            bank, slide_ids = src.batch(ids)
            stats = engine.train_step(bank, slide_ids, torch.Generator().manual_seed(i))
            losses.append(float(stats.loss))
            if i == 0:
                print(f"first step (build) done, loss {losses[0]:.4f}", flush=True)
                t0 = time.perf_counter()
        rate = (steps - 1) / (time.perf_counter() - t0) if steps > 1 else float("nan")
        print(f"stage-3 streaming train: {rate:.2f} steps/s at B={b}, bags {lo}-{hi}, "
              f"last loss {losses[-1]:.4f}", flush=True)

        # full-bag heatmap attention over the largest slide
        scorer = AttentionScorer(dim_patch=D, num_classes=2, bucket=2048, device=dev)
        paths = [r["features_filepath"] for r in load_manifest(ds["data_csv"])]
        feats = load_features_npz(max(paths, key=lambda p: npy_member_span(p)[1][0]))
        t0 = time.perf_counter()
        att = scorer(feats)
        secs = time.perf_counter() - t0
        finite = bool(np.isfinite(att).all())
        print(f"full-bag attention over {feats.shape[0]} patches: {secs:.2f}s, finite={finite}")
        print("SCALE SMOKE OK")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"losses": losses, "steps_per_s": rate, "nmax": src.max_patches,
            "attention_s": secs, "attention_n": int(feats.shape[0]), "attention_finite": finite}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=5, default=list(SHAPE),
                    metavar=("SLIDES", "MIN", "MAX", "BATCH", "STEPS"))
    ap.add_argument("--root", default=None, help="where to write the slides (kept)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.root)
