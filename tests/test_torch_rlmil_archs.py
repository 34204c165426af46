"""Port's supervised RLMIL CLI for ABMIL and DSMIL end to end on the CPU plain path.

- ABMIL ``finetune`` stages 1 -> 2 -> 3 from a port ABMIL MuRCL run (the
  aggregator's keys load; stage 2 trains the policy only);
- DSMIL ``scratch`` stages 1 -> 2 -> 3;
- DSMIL ``linear`` stages 1 -> 2 -> 3 from the same ABMIL pretrain, the
  JAX package's DSMIL route (``tests/test_drivers.py:187-230``): no
  aggregator key of the ABMIL pretrain fits DSMIL, stage 1 trains only the
  GRU head, and stage 2 takes the pretrain's policy (ABMIL's L equals
  DSMIL's patch-wide state).

Every run dir holds the files ``tests/test_torch_rlmil_driver.py`` lists.
"""

import csv
import math
from pathlib import Path

import pytest
import torch

from murcl_tpu_torch import train_MuRCL, train_RLMIL
from murcl_tpu_torch.drivers import rlmil

FILES = ("args.json", "losses.csv", "accs.csv", "aucs.csv", "results.csv", "pred.csv",
         "final_res.csv", "checkpoint.pth.tar", "model_best.pth.tar")
DIM = 32  # the synthetic dataset's patch width, which ABMIL's L matches below


def _argv(ds, tmp_path, arch, method, stage, *extra):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--feat_size", "16", "--T", "2", "--base_save_dir",
            str(tmp_path / "rlmil"), "--arch", arch, "--train_method", method,
            "--train_stage", str(stage), "--epochs", "1", "--ppo_epochs", "1",
            "--batch_size", "3", "--save_model", "--L", str(DIM), *extra]


@pytest.fixture()
def abmil_pretrained(synthetic_dataset, tmp_path):
    """A port ABMIL MuRCL run, stages 1 -> 2 -> 3; its stage-3 best checkpoint."""
    out = None
    for stage in (1, 2, 3):
        out = train_MuRCL.main(
            ["--data_csv", synthetic_dataset["data_csv"], "--data_split_json",
             synthetic_dataset["data_split_json"], "--device", "cpu", "--epochs", "1",
             "--ppo_epochs", "1", "--batch_size", "2", "--data_repeat", "1", "--feat_size",
             "16", "--T", "2", "--arch", "ABMIL", "--model_dim", str(DIM), "--train_stage",
             str(stage), "--base_save_dir", str(tmp_path / "murcl")])
    return str(Path(out["save_dir"]) / "model_best.pth.tar")


def _stages(ds, tmp_path, arch, method, pretrained=None):
    runs = []
    for stage in (1, 2, 3):
        extra = ["--checkpoint_pretrained", pretrained] if pretrained and stage < 3 else []
        out = train_RLMIL.main(_argv(ds, tmp_path, arch, method, stage, *extra))
        assert all(math.isfinite(v) for v in out["final"]), out["final"]
        runs.append(Path(out["save_dir"]))
    assert [r.name for r in runs] == ["stage_1", "stage_2", "stage_3"]
    assert len({r.parent for r in runs}) == 1
    assert runs[0].parts[-6] == arch and runs[0].parts[-4] == method
    for stage, run in enumerate(runs, 1):
        for name in FILES:
            assert (run / name).exists(), (stage, name)
        ckpt = torch.load(run / "checkpoint.pth.tar", weights_only=True)
        assert (ckpt["policy"] is None) == (stage == 1)
        with open(run / "losses.csv") as fp:
            rows = list(csv.DictReader(fp))
        assert len(rows) == 1 and math.isfinite(float(rows[0]["train"]))
    return [torch.load(r / "model_best.pth.tar", weights_only=True) for r in runs]


def _equal(a, b):
    return all(torch.equal(v, b[k]) for k, v in a.items())


def test_abmil_finetune_stages_1_2_3(synthetic_dataset, tmp_path, abmil_pretrained):
    s1, s2, s3 = _stages(synthetic_dataset, tmp_path, "ABMIL", "finetune", abmil_pretrained)
    assert s1["model_state_dict"]["encoder.0.weight"].shape == (DIM, DIM)
    # stage 2 trains the policy only; stage 3 trains the aggregator again
    assert _equal(s1["model_state_dict"], s2["model_state_dict"]) and _equal(s1["fc"], s2["fc"])
    assert not _equal(s2["model_state_dict"], s3["model_state_dict"])


def test_dsmil_scratch_stages_1_2_3(synthetic_dataset, tmp_path):
    s1, s2, s3 = _stages(synthetic_dataset, tmp_path, "DSMIL", "scratch")
    assert s1["model_state_dict"]["b_classifier.fcc.weight"].shape == (2, 2, DIM)
    assert _equal(s1["model_state_dict"], s2["model_state_dict"])
    assert not _equal(s2["model_state_dict"], s3["model_state_dict"])
    assert _equal(s2["policy"], s3["policy"])


def test_dsmil_linear_stages_from_abmil_pretrain(synthetic_dataset, tmp_path,
                                                 abmil_pretrained, capsys):
    s1, s2, s3 = _stages(synthetic_dataset, tmp_path, "DSMIL", "linear", abmil_pretrained)

    def setup(stage):
        capsys.readouterr()
        return rlmil.setup(train_RLMIL.parse_args(_argv(
            synthetic_dataset, tmp_path, "DSMIL", "linear", stage, "--checkpoint_pretrained",
            abmil_pretrained, "--exist_ok")))

    # no key of the ABMIL pretrain fits; linear eval freezes DSMIL whole, so
    # the fresh aggregator stays as it was through every stage
    fresh = setup(1).model.state_dict()
    assert "kept fresh init for 8 entries" in capsys.readouterr().out
    for s in (s1, s2, s3):
        assert _equal(fresh, s["model_state_dict"])
    # stage 2 starts from the pretrain's policy
    pretrained = torch.load(abmil_pretrained, weights_only=True)
    assert _equal(pretrained["policy"], setup(2).ppo.policy.state_dict())
