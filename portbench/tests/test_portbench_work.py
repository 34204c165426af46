"""The yardstick's counts from shapes, and the harness finding a cell that
was added by files alone."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import spec, work

SHAPE = (1536, 1024, 512, 512, 256)  # bags, rows, Fin, L1, D: stage 1's K2/K3 call


def test_k2_k3_counts_match_the_kernel_table():
    assert work.k2_flops(*SHAPE) / 1e12 == pytest.approx(1.65, abs=0.005)
    assert work.k3_flops(*SHAPE) / 1e12 == pytest.approx(4.13, abs=0.01)


def test_function_counts():
    b, n, fin, l1, d = SHAPE
    r = b * n
    fwd = 2 * r * fin * l1 + 4 * r * l1 * d + 2 * r * d + 2 * r * l1
    assert work.clam_flops(*SHAPE) == 3 * fwd - 2 * r * fin * l1
    # ABMIL at MuRCL's widths: about 7.2 TFLOP over a stage-1 step's bags
    assert work.abmil_flops(b, n, 512, 512, 128) / 1e12 == pytest.approx(7.22, abs=0.01)
    cfg = spec.plan("clam_sb-f32.pretrain_s1").config
    assert work.aggregator_flops(cfg, b, n) == work.clam_flops(*SHAPE)


def test_step_flops_and_bound():
    p = spec.plan("clam_sb-f32.pretrain_s1")
    total = work.step_flops(p.config, p.traffic)
    agg = work.clam_flops(*SHAPE)
    assert agg < total < 1.02 * agg  # the head, the loss: about 1% more
    s3 = spec.plan("clam_sb-f32.pretrain_s3")
    assert work.step_flops(s3.config, s3.traffic) > total  # the policy's acts
    assert work.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)


def test_a_cell_added_by_files(tmp_path):
    root = tmp_path
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    here = root / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(here / "configs" / "clam_sb-f32.json", here / "configs" / "clam_sb-big.json")
    shutil.copy(here / "traffic" / "pretrain_s1.json", here / "traffic" / "burst.json")
    shutil.copy(here / "metrics" / "step.mfu.py", here / "metrics" / "head.mfu.py")
    shutil.copy(here / "limits" / "clam_sb-f32.pretrain_s1.json",
                here / "limits" / "clam_sb-big.burst.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "clam_sb-big", "source": "test",
                           "file": "portbench/configs/clam_sb-big.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "clam_sb-big.burst", "config": "clam_sb-big",
                             "traffic": "burst", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "head.mfu", "unit": "%", "better": "higher",
                             "source": "host_clock", "layer": "whole step",
                             "moves": "slides_per_s", "workloads": ["clam_sb-big.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    assert "clam_sb-big.burst" in spec.cells(root)
    p = spec.plan("clam_sb-big.burst", root=root, here=here)
    assert p.config["arch"] == "CLAM_SB" and p.traffic["stage"] == 1
    assert "head.mfu" in p.readers and hasattr(p.readers["head.mfu"], "read")
    assert "aggregator.k2k3_roofline" not in p.readers  # listed for other cells
    assert [m["name"] for m in p.end_to_end] == [m["name"] for m in man["end_to_end"]]
    assert p.limits == json.loads((here / "limits" / "clam_sb-big.burst.json").read_text())
    # only files were added: every file the tree had is as it was
    copied = {f.relative_to(here): f.read_bytes() for f in here.rglob("*")
              if f.is_file() and "__pycache__" not in f.parts}
    original = {f.relative_to(spec.HERE): f.read_bytes() for f in spec.HERE.rglob("*")
                if f.is_file() and "__pycache__" not in f.parts}
    assert all(copied[k] == v for k, v in original.items())
    assert {str(k) for k in set(copied) - set(original)} == {
        "configs/clam_sb-big.json", "traffic/burst.json", "metrics/head.mfu.py",
        "limits/clam_sb-big.burst.json"}
