"""The ports of ``scripts/profile_step.py`` and ``profile_stages.py``
(``murcl_tpu_torch/scripts/``) and their helpers (``scripts/profiling.py``)
on the CPU, at a small size: 4 slides of 96 patches, D 32, feat 64, batch
8, T 2.

Each script runs end to end with ``--device cpu`` (the plain twins; the
table holds host times) and prints the JAX scripts' table, ``ms/step
calls  op``, and writes its trace; ``profile_stages`` at stage 2 prints the
PPO updates' share. ``op_table`` and ``busy_union_ms`` are exact on
hand-made intervals (disjoint, overlapping, nested). The scripts' bank is
bitwise the JAX scripts' bank in bf16, drawn as ``scripts/profile_step.py``
draws it. Without a card their default device raises: no fallback.
"""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu_torch.scripts import profile_stages, profile_step, profiling

SHAPE = (4, 96, 32, 64, 8, 2)


def _ev(name, a, b):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b))


# (events as (name, start us, end us), steps, {op: (ms, calls, sum_ms, union_ms)}, busy ms)
CASES = {
    "disjoint": ([("a", 0, 10), ("a", 20, 30), ("b", 40, 45)], 1,
                 {"a": (0.02, 2, 0.02, 0.02), "b": (0.005, 1, 0.005, 0.005)}, 0.025),
    "overlapping": ([("a", 0, 10), ("a", 5, 15), ("b", 12, 20)], 1,
                    {"a": (0.02, 2, 0.02, 0.015), "b": (0.008, 1, 0.008, 0.008)}, 0.02),
    "nested": ([("a", 0, 100), ("b", 10, 20), ("a", 30, 40), ("b", 15, 18)], 2,
               {"a": (0.055, 1, 0.11, 0.1), "b": (0.0065, 1, 0.013, 0.01)}, 0.1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_table_and_busy_union_exact(case):
    raw, steps, want, busy = CASES[case]
    events = [_ev(*e) for e in raw]
    rows = profiling.op_table(events, steps)
    assert [r["op"] for r in rows] == sorted(want, key=lambda k: -want[k][2])
    for r in rows:
        ms, calls, sum_ms, union_ms = want[r["op"]]
        assert r["ms"] == pytest.approx(ms, abs=1e-12) and r["calls"] == calls
        assert r["sum_ms"] == pytest.approx(sum_ms, abs=1e-12)
        assert r["union_ms"] == pytest.approx(union_ms, abs=1e-12)
    assert profiling.busy_union_ms(events) == pytest.approx(busy, abs=1e-12)
    assert profiling.op_table(events, steps, top=1) == rows[:1]


def test_print_table_cuts_names(capsys):
    rows = profiling.op_table([_ev("k" * 150, 0, 2000)], 1)
    profiling.print_table(rows, on_device=False)
    out = capsys.readouterr().out.splitlines()
    assert "host times of the plain twins" in out[0]
    assert out[1].split() == ["ms/step", "calls", "op"]
    assert out[2].split() == ["2.00", "1", "k" * 100]


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(ml_dtypes.bfloat16).view(np.int16)


def test_bank_is_the_jax_scripts():
    slides, patches, d = SHAPE[:3]
    s = profile_step.build_step(torch.device("cpu"), SHAPE)
    # scripts/profile_step.py:43-51, at this size
    rng = np.random.default_rng(0)
    feats, clusters, labels = [], [], []
    for i in range(slides):
        feats.append(rng.normal(size=(patches, d)).astype(np.float32))
        a = rng.integers(0, 10, size=patches)
        clusters.append([[int(j) for j in np.where(a == c)[0]] for c in range(10)])
        labels.append(i % 2)
    jb = jax_bank_from_arrays(feats, clusters, labels).device(dtype=jnp.bfloat16)
    bank = s.bank
    np.testing.assert_array_equal(_bf16_bits(bank.feats),
                                  _bf16_bits(jb.feats[:bank.feats.shape[0]]))
    np.testing.assert_array_equal(bank.labels.numpy(), np.asarray(jb.labels))
    np.testing.assert_array_equal(bank.num_patches.numpy(), np.asarray(jb.num_patches))
    np.testing.assert_array_equal(bank.cluster_sizes.numpy(), np.asarray(jb.cluster_sizes))
    assert s.ids.tolist() == [i % slides for i in range(SHAPE[4])]


def _check_run(res, out, trace):
    assert "ms/step" in out and "calls" in out and "host times of the plain twins" in out
    assert not res["on_device"] and res["rows"] and res["step_ms"] > 0 and res["busy_ms"] > 0
    assert all(np.isfinite(res["losses"])) and len(res["losses"]) == 2
    assert json.loads(trace.read_text())["traceEvents"]


def test_profile_step_runs_on_cpu(tmp_path, capsys):
    trace = tmp_path / "step.json"
    res = profile_step.run("cpu", SHAPE, steps=2, out=trace)
    out = capsys.readouterr().out
    _check_run(res, out, trace)
    assert any(r["op"] == "_FusedTrunkAttention" for r in res["rows"])
    assert any(r["op"] == "Optimizer.step#Adam.step" and r["calls"] == 1 for r in res["rows"])


@pytest.mark.parametrize("stage", [2, 3])
def test_profile_stages_run_on_cpu(tmp_path, capsys, stage):
    trace = tmp_path / f"stage{stage}.json"
    res = profile_stages.run("cpu", SHAPE, stage=stage, steps=2, out=trace)
    out = capsys.readouterr().out
    _check_run(res, out, trace)
    calls = {r["op"]: r["calls"] for r in res["rows"]}
    if stage == 2:
        # the updates' spans, two a step, each K_epochs 3 steps of the
        # policy's Adam; the aggregator has no optimizer
        assert calls[profile_stages.UPDATE] == 2 and calls["Optimizer.step#Adam.step"] == 6
        assert 0 < res["update_share"] and "the two PPO updates" in out
    else:
        assert "update_share" not in res and calls["Optimizer.step#Adam.step"] == 1
        assert profile_stages.UPDATE not in calls


def test_profile_stages_refuse_stage_1():
    with pytest.raises(ValueError, match="stage 2 or 3"):
        profile_stages.run("cpu", SHAPE, stage=1)


@pytest.mark.parametrize("mod", [profile_step, profile_stages])
def test_default_device_is_the_card(mod):
    args = mod.parse_args([])
    assert args.device == "cuda:0" and tuple(args.shape) == profile_step.SHAPE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run()
