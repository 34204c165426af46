"""Port's MuRCL CLI, stages 1 -> 2 -> 3, for CLAM_SB and ABMIL, on the CPU plain path.

``python -m murcl_tpu_torch.train_MuRCL --device cpu`` on a tiny synthetic
dataset (feat_size 32, T 3, batch 2): each stage chains on
``../stage_{N-1}/model_best.pth.tar``; every run dir has its files; the
checkpoint holds a policy at stages 2 and 3 only; stage 2 leaves every
aggregator and head weight bitwise as stage 1 left it; stage 3 leaves the
policy bitwise as stage 2 left it; and ``--resume`` restores the policy and
its optimizer.
"""

import csv
import math
from pathlib import Path

import pytest
import torch

from murcl_tpu_torch.drivers import murcl as murcl_driver
from murcl_tpu_torch.train_MuRCL import main, parse_args


def _argv(ds, tmp_path, arch, stage, *extra):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--epochs", "1", "--ppo_epochs", "1", "--batch_size", "2",
            "--data_repeat", "1", "--feat_size", "32", "--T", "3", "--arch", arch,
            "--train_stage", str(stage), "--base_save_dir", str(tmp_path), *extra]


def _load(run, name="model_best.pth.tar"):
    return torch.load(run / name, weights_only=True)


@pytest.mark.parametrize("arch", ["CLAM_SB", "ABMIL"])
def test_cli_stages_1_2_3(synthetic_dataset, tmp_path, arch):
    runs = [Path(main(_argv(synthetic_dataset, tmp_path, arch, stage))["save_dir"])
            for stage in (1, 2, 3)]
    assert [r.name for r in runs] == ["stage_1", "stage_2", "stage_3"]
    assert len({r.parent for r in runs}) == 1 and runs[0].parent.parts[-4] == arch
    for stage, run in enumerate(runs, 1):
        for name in ("args.json", "losses.csv", "results.csv", "checkpoint.pth.tar",
                     "model_best.pth.tar"):
            assert (run / name).exists(), (stage, name)
        with open(run / "losses.csv") as fp:
            rows = list(csv.DictReader(fp))
        assert len(rows) == 1 and math.isfinite(float(rows[0]["train"]))
        ckpt = _load(run, "checkpoint.pth.tar")
        assert (ckpt["policy"] is None) == (stage == 1)
        assert (ckpt["ppo_optimizer"] is None) == (stage == 1)
        assert (ckpt["optimizer"] is None) == (stage == 2)
        assert all(k.startswith("encoder.") for k in ckpt["model_state_dict"])
    s1, s2, s3 = (_load(r) for r in runs)
    # stage 2 trains the policy only
    for part in ("model_state_dict", "fc"):
        for k, v in s1[part].items():
            assert torch.equal(v, s2[part][k]), (part, k)
    # stage 3 trains aggregator and head under the policy stage 2 left
    for k, v in s2["policy"].items():
        assert torch.equal(v, s3["policy"][k]), k
    assert any(not torch.equal(v, s3["model_state_dict"][k])
               for k, v in s2["model_state_dict"].items())


def test_resume_restores_policy(synthetic_dataset, tmp_path):
    for stage in (1, 2):
        out = main(_argv(synthetic_dataset, tmp_path, "ABMIL", stage))
    run = Path(out["save_dir"])
    ckpt = _load(run, "checkpoint.pth.tar")
    args = parse_args(_argv(synthetic_dataset, tmp_path, "ABMIL", 2, "--exist_ok", "--resume",
                            "--ppo_epochs", "2"))
    s = murcl_driver.setup(args)
    assert Path(args.save_dir) == run and s.start_epoch == 1 and s.optimizer is None
    for k, v in ckpt["policy"].items():
        assert torch.equal(s.ppo.policy.state_dict()[k], v), k
        assert torch.equal(s.ppo.policy_old.state_dict()[k], v), k
    assert s.ppo.optimizer.state_dict()["state"]  # Adam moments came back
    for k, v in ckpt["ppo_optimizer"]["state"][0].items():
        assert torch.equal(s.ppo.optimizer.state_dict()["state"][0][k], v), k
    # the run continues to epoch 2 from there
    out = main(_argv(synthetic_dataset, tmp_path, "ABMIL", 2, "--exist_ok", "--resume",
                     "--ppo_epochs", "2"))
    assert _load(run, "checkpoint.pth.tar")["epoch"] == 2


def test_stage_2_needs_stage_1(synthetic_dataset, tmp_path):
    with pytest.raises(FileNotFoundError, match="stage_1"):
        main(_argv(synthetic_dataset, tmp_path, "CLAM_SB", 2))
