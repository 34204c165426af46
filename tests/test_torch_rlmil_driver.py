"""Port's supervised RLMIL CLI end to end on the CPU plain path.

Stage 1 fine-tunes from a MuRCL checkpoint the port itself wrote, then
stages 2 and 3 chain on ``../stage_{N-1}/model_best.pth.tar``; every stage
writes its csv logs, checkpoints (with the policy from stage 2 on),
``pred.csv`` and ``final_res.csv``. Batch 3 over 4 train slides exercises
the padded last batch. A ``--dp_devices`` that does not divide the batch
raises, and importing the CLI leaves JAX, pandas, yaml and scikit-learn
unloaded.
"""

import csv
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from murcl_tpu_torch import train_MuRCL, train_RLMIL

REPO = Path(__file__).resolve().parents[1]


def _common(ds, tmp_path):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--feat_size", "16", "--T", "2", "--base_save_dir",
            str(tmp_path / "rlmil")]


@pytest.fixture()
def pretrained(synthetic_dataset, tmp_path):
    out = train_MuRCL.main(
        ["--data_csv", synthetic_dataset["data_csv"], "--data_split_json",
         synthetic_dataset["data_split_json"], "--device", "cpu", "--epochs", "1",
         "--batch_size", "2", "--data_repeat", "1", "--feat_size", "16", "--T", "2",
         "--base_save_dir", str(tmp_path / "murcl"), "--save_dir", "run"])
    return str(Path(out["save_dir"]) / "model_best.pth.tar")


def test_cli_finetune_stages_1_2_3(synthetic_dataset, tmp_path, pretrained):
    runs = []
    for stage in (1, 2, 3):
        extra = ["--checkpoint_pretrained", pretrained] if stage < 3 else []
        out = train_RLMIL.main(_common(synthetic_dataset, tmp_path) + [
            "--train_method", "finetune", "--train_stage", str(stage), "--epochs", "1",
            "--ppo_epochs", "1", "--batch_size", "3", "--save_model", *extra])
        runs.append(Path(out["save_dir"]))
        assert all(math.isfinite(v) for v in out["final"]), out["final"]
    assert [r.name for r in runs] == ["stage_1", "stage_2", "stage_3"]
    assert len({r.parent for r in runs}) == 1
    for stage, run in enumerate(runs, 1):
        for name in ("args.json", "losses.csv", "accs.csv", "aucs.csv", "results.csv",
                     "pred.csv", "final_res.csv", "checkpoint.pth.tar", "model_best.pth.tar"):
            assert (run / name).exists(), (stage, name)
        ckpt = torch.load(run / "checkpoint.pth.tar", weights_only=True)
        assert (ckpt["policy"] is None) == (stage == 1)
        assert not any(k.startswith("encoder.") for k in ckpt["model_state_dict"])
        assert ckpt["model_state_dict"]["classifiers.weight"].shape == (2, 512)
        with open(run / "losses.csv") as fp:
            rows = list(csv.DictReader(fp))
        assert len(rows) == 1 and math.isfinite(float(rows[0]["train"]))
        with open(run / "pred.csv") as fp:
            preds = list(csv.DictReader(fp))
        assert len(preds) == 2 and set(preds[0]) == {"case_id", "label", "pred", "correct",
                                                     "prob0", "prob1"}
        with open(run / "final_res.csv") as fp:
            final = list(csv.reader(fp))
        assert final[0] == ["", "loss", "acc", "auc", "precision", "recall", "f1_score"]
        assert final[1][0] == "seed985"
    # stage 2 trains the policy only: the aggregator it saved is stage 1's
    s1 = torch.load(runs[0] / "model_best.pth.tar", weights_only=True)
    s2 = torch.load(runs[1] / "model_best.pth.tar", weights_only=True)
    for k, v in s1["model_state_dict"].items():
        assert torch.equal(v, s2["model_state_dict"][k]), k


# --streaming (tests/test_torch_streaming.py), --policy_conv
# (tests/test_torch_policy_heads.py) and --dp_devices (tests/test_torch_dp*.py)
# are ported; a --dp_devices that does not divide the batch (1 here) raises
@pytest.mark.parametrize("extra", [("--dp_devices", "2")])
def test_unported_flags_raise(synthetic_dataset, tmp_path, extra):
    with pytest.raises(ValueError, match="divisible by --dp_devices"):
        train_RLMIL.main(_common(synthetic_dataset, tmp_path) + list(extra))


def test_import_leaves_jax_out():
    code = ("import sys, murcl_tpu_torch.drivers.rlmil, murcl_tpu_torch.train_RLMIL; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'pandas', 'yaml', 'sklearn', 'murcl_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
