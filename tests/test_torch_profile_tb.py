"""``--profile N`` and ``--use_tensorboard`` in the port's two drivers, on
the CPU.

- ``--profile 2`` writes a ``torch.profiler`` trace of the first two steps
  into ``<save_dir>/profile`` (Chrome's trace format, naming the steps'
  operators and the program's spans), in MuRCL and in supervised RLMIL,
  and ``host_waits.json`` beside it (the host-wait counter arms on the card
  only, so its list is empty here).
- ``--use_tensorboard`` writes the scalar tags the JAX drivers write
  (``murcl_tpu/drivers/murcl.py`` and ``rlmil.py``, read from their
  source), one value per epoch, read back with tensorboard's own event
  reader.
- With tensorboard blocked, a driver prints that logging is disabled and
  trains on.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from murcl_tpu_torch import train_MuRCL, train_RLMIL

REPO = Path(__file__).resolve().parents[1]


def _jax_tags(name):
    source = (REPO / "murcl_tpu" / "drivers" / f"{name}.py").read_text()
    return sorted(set(re.findall(r'add_scalar\("([^"]+)"', source)))


def _murcl_argv(ds, tmp_path, *extra):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--epochs", "2", "--batch_size", "2", "--data_repeat", "2",
            "--feat_size", "16", "--T", "2", "--base_save_dir", str(tmp_path),
            "--save_dir", "run", *extra]


def _rlmil_argv(ds, tmp_path, *extra):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--feat_size", "16", "--T", "2", "--batch_size", "2",
            "--epochs", "2", "--train_method", "scratch", "--base_save_dir",
            str(tmp_path / "rlmil"), *extra]


def _scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@pytest.mark.parametrize("driver", ["murcl", "rlmil"])
def test_profile_writes_a_trace(synthetic_dataset, tmp_path, driver):
    if driver == "murcl":
        out = train_MuRCL.main(_murcl_argv(synthetic_dataset, tmp_path, "--profile", "2"))
    else:
        out = train_RLMIL.main(_rlmil_argv(synthetic_dataset, tmp_path, "--profile", "2"))
    traces = list((Path(out["save_dir"]) / "profile").glob("*.pt.trace.json"))
    assert [t.name for t in traces] == ["steps_1-2.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert {"murcl.step", "murcl.select", "murcl.aggregator", "murcl.head",
            "murcl.optimizer"} <= names
    waits = json.loads((traces[0].parent / "host_waits.json").read_text())
    assert waits == {"steps": 2, "waits": []}


@pytest.mark.parametrize("driver", ["murcl", "rlmil"])
def test_tensorboard_writes_the_jax_drivers_tags(synthetic_dataset, tmp_path, driver):
    if driver == "murcl":
        out = train_MuRCL.main(_murcl_argv(synthetic_dataset, tmp_path, "--use_tensorboard"))
    else:
        out = train_RLMIL.main(_rlmil_argv(synthetic_dataset, tmp_path, "--use_tensorboard"))
    scalars = _scalars(out["save_dir"])
    assert sorted(scalars) == _jax_tags(driver)
    assert all(steps == [0, 1] for steps in scalars.values()), scalars


def test_tensorboard_blocked_prints_and_trains_on(synthetic_dataset, tmp_path):
    code = (
        "import sys\n"
        "sys.modules['tensorboard'] = None\n"
        "sys.modules['torch.utils.tensorboard'] = None\n"
        "from murcl_tpu_torch import train_MuRCL\n"
        f"out = train_MuRCL.main({_murcl_argv(synthetic_dataset, tmp_path, '--use_tensorboard')!r})\n"
        "print('best', out['best_loss'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "tensorboard unavailable" in proc.stdout and "logging disabled" in proc.stdout
    assert "best " in proc.stdout
    assert not list((tmp_path / "run").glob("events.out.tfevents.*"))
