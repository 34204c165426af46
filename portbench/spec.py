"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names, each found by name, so that a cell, a configuration, a
traffic mix or a per-layer metric is added by adding files:

- ``configs/<config>.json``: the configuration (the manifest's ``file``);
- ``traffic/<traffic>.json``: the mix's parameters;
- ``metrics/<metric>.py``: the reader of a per-layer metric, a module with
  ``read(run) -> float | None``;
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares in that cell.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as fp:
        return json.load(fp)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)


def cells(root: Path = ROOT) -> List[str]:
    return [w["name"] for w in manifest(root)["workloads"]]


def reader(name: str, here: Path = HERE) -> ModuleType:
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench.metrics." + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan(cell: str, root: Path = ROOT, here: Path = HERE) -> SimpleNamespace:
    """Everything a run of ``cell`` needs: its manifest entry, configuration,
    traffic, the end-to-end and per-layer metrics it reports (the per-layer
    ones with their readers) and its limits."""
    man = manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; it has {sorted(work)}")
    w = work[cell]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]

    def mine(m):
        return cell in m.get("workloads", [cell])

    per_layer = [m for m in man["per_layer"] if mine(m)]
    return SimpleNamespace(
        name=cell, workload=w, chips=w["chips"], config=_json(root / conf["file"]),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in man["end_to_end"] if mine(m)], per_layer=per_layer,
        readers={m["name"]: reader(m["name"], here) for m in per_layer},
        limits=_json(here / "limits" / f"{cell}.json"))
