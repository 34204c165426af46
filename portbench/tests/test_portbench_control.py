"""The harness on the CPU at a tiny size, past its look for a card: sound
runs come out correct; the control (the reference in TF32 in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct, against the limits of the cell each tiny one stands for."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, check, run, spec
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def args(cell, seed, trace=0):
    return run.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
                           "--trace", str(trace)])


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell):
    out = run.run_cell(args(cell, 2 ** 31 + 17), device=CPU, root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"slides_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"}
    assert list(out["checks"]) == list(spec.plan(cell, root=root, here=root / "portbench").limits)


def test_traced_run_reports_per_layer(root):
    out = run.run_cell(args("tiny_clam.s3", 5, trace=1), device=CPU, root=root)
    assert out["correct"], out["checks"]
    # no device on the CPU: the readers of the card's trace find nothing
    assert {"engine.host_enqueue_ms", "step.mfu"} <= set(out["metrics"])
    assert "aggregator.k2k3_roofline" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "device_ops" in out["breakdown"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(root, cell):
    plan = spec.plan(cell, root=root, here=root / "portbench")
    for seed in (3, 4, 5):
        numbers = calibrate.control_reading(plan, seed, CPU)
        assert not check.verdict(numbers, plan.limits), numbers


FAULTS = [(c, f) for c in sorted(tiny.CELLS) for f in ("half_batch", "frozen")] + [
    ("tiny_clam.s3", "act_shift")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(root, cell, fault):
    out = run.run_cell(args(cell, 11), device=CPU, fault=calibrate.FAULTS[fault], root=root)
    assert not out["correct"], out["checks"]
