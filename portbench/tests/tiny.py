"""A tiny copy of the benchmark's tree for CPU tests: the same harness over
small configurations and traffic, in a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import spec

TINY_CLAM = {"name": "tiny_clam", "source": "test", "arch": "CLAM_SB", "compute_dtype": "float32",
             "tf32": False, "dim_in": 32, "size_arg": "small", "L1": 512, "D": 256, "gate": True,
             "dropout": 0.25, "k_sample": 8, "subtyping": True, "projection_dim": 8,
             "fc_hidden_dim": 16, "policy_hidden_dim": 16, "action_std": 0.5, "ppo_lr": 1e-5,
             "ppo_gamma": 0.1, "K_epochs": 3, "optimizer": "Adam", "beta1": 0.9,
             "beta2": 0.999, "wdecay": 1e-5, "reduced": []}
TINY_ABMIL = {**{k: v for k, v in TINY_CLAM.items() if k not in ("L1", "D", "size_arg", "gate",
                                                                   "k_sample", "subtyping")},
              "name": "tiny_abmil", "arch": "ABMIL", "L": 48, "D": 16, "dropout": 0.0}


def traffic(stage: int) -> dict:
    return {"stage": stage, "batch": 6, "T": 3, "num_clusters": 4, "feat_size": 40, "alpha": 0.9,
            "temperature": 1.0, "backbone_lr": 1e-4, "fc_lr": 5e-5,
            "bank": {"slides": 9, "patches_min": 60, "patches_max": 150}, "data_repeat": 10,
            "checked_steps": 3}


CELLS = {"tiny_clam.s1": ("tiny_clam", "tiny_s1"), "tiny_abmil.s1": ("tiny_abmil", "tiny_s1"),
         "tiny_clam.s3": ("tiny_clam", "tiny_s3")}
# the benchmark's cell each tiny one stands for: it is held to that cell's limits
STANDS_FOR = {"tiny_clam.s1": "clam_sb-f32.pretrain_s1", "tiny_abmil.s1": "abmil-f32.pretrain_s1",
              "tiny_clam.s3": "clam_sb-f32.pretrain_s3"}


def make_root(tmp: Path) -> Path:
    """``tmp`` holding a ``BENCHMARK.json`` of the tiny cells and a copy of
    ``portbench/`` with their files beside the real ones."""
    root = Path(tmp)
    here = root / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = spec.manifest()
    for cfg in (TINY_CLAM, TINY_ABMIL):
        (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": cfg["name"], "source": "test",
                               "file": f"portbench/configs/{cfg['name']}.json", "reduced": [],
                               "why": "test"})
    for stage in (1, 3):
        (here / "traffic" / f"tiny_s{stage}.json").write_text(json.dumps(traffic(stage)))
    for cell, (conf, mix) in CELLS.items():
        man["workloads"].append({"name": cell, "config": conf, "traffic": mix, "chips": 1,
                                 "why": "test"})
        shutil.copy(here / "limits" / f"{STANDS_FOR[cell]}.json", here / "limits" / f"{cell}.json")
    for m in man["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c, (conf, _) in CELLS.items()
                               if (conf == "tiny_clam") == ("k2k3" in m["name"])]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root
