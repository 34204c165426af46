"""The RLMIL CLI with ``--device cpu --dp_devices 2`` (two gloo ranks),
stages 1 -> 2 -> 3 from scratch, on the shared ``synthetic_dataset``
fixture (4 training slides, batch 4; 2 validation and 2 test slides), with
the checks of ``tests/test_torch_dp_cli.py`` (``torch_dp_ranks.check_runs``):
rank 0's files alone, finite losses and final metrics, the single-process
checkpoint layout, stage 2 leaving the aggregator as stage 1 left it, both
ranks' launch counts. The dp stage-1 ``model_best`` chains into a
single-process stage 2, and ``--streaming --dp_devices 2`` writes the
``losses.csv``, ``final_res.csv`` and ``pred.csv`` of ``--dp_devices 2``,
byte for byte.
"""

import csv
import math
from pathlib import Path

from torch_dp_ranks import FILES, check_runs, load

from murcl_tpu_torch import train_RLMIL

RLMIL_FILES = FILES | {"accs.csv", "aucs.csv", "pred.csv", "final_res.csv"}


def _rlmil(ds, base, stage, *extra):
    return train_RLMIL.main(
        ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
         "--device", "cpu", "--epochs", "1", "--ppo_epochs", "1", "--batch_size", "4",
         "--feat_size", "16", "--T", "2", "--train_stage", str(stage), "--save_model",
         "--base_save_dir", str(base), *extra])


def test_rlmil_cli_stages_on_two_ranks(synthetic_dataset, tmp_path):
    ds = synthetic_dataset
    outs = [_rlmil(ds, tmp_path / "dp", stage, "--dp_devices", "2") for stage in (1, 2, 3)]
    runs = check_runs(outs, RLMIL_FILES)
    assert all(math.isfinite(v) for out in outs for v in out["final"])
    with open(runs[0] / "pred.csv") as fp:
        assert len(list(csv.DictReader(fp))) == 2
    # dp stage 1 -> single-process stage 2
    single = _rlmil(ds, tmp_path, 2, "--save_dir", "single/stage_2", "--checkpoint_stage",
                    str(runs[0] / "model_best.pth.tar"))
    assert all(math.isfinite(v) for v in single["final"])
    for k, v in load(runs[0])["model_state_dict"].items():
        assert (v == load(single["save_dir"])["model_state_dict"][k]).all(), k
    # --streaming on two ranks writes the resident run's files
    stream = Path(_rlmil(ds, tmp_path / "stream", 1, "--dp_devices", "2",
                         "--streaming")["save_dir"])
    for name in ("losses.csv", "final_res.csv", "pred.csv"):
        assert (runs[0] / name).read_text() == (stream / name).read_text(), name
