"""The MuRCL CLI with ``--device cpu --dp_devices 2`` (two gloo ranks),
stages 1 -> 2 -> 3, on the shared ``synthetic_dataset`` fixture (4
training slides):

- each stage's run directory holds rank 0's files and nothing else (no
  second rank's, no rendezvous file, no incremented sibling), finite losses,
  and checkpoints in the single-process layout (no ``module.`` prefix, the
  aggregator under ``encoder.``; the policy from stage 2 on); stage 2 leaves
  the aggregator bitwise as stage 1 left it; the launcher hands back both
  ranks' kernel launch counts;
- the dp stage-1 ``model_best`` chains into a single-process stage 2, whose
  ``model_best`` chains into a dp stage 3, and the dp run's CLAM_SB
  checkpoint loads in the heatmap scorer;
- ``--streaming --dp_devices 2`` writes the ``losses.csv`` ``--dp_devices 2``
  writes, byte for byte (on the CPU the staged mini-banks give the resident
  bank's bits and every step is deterministic, so the rates stay the CLI's).

``tests/test_torch_dp_rlmil_cli.py`` does the same for the RLMIL CLI.
"""

import math
from pathlib import Path

import pytest
import torch
from torch_dp_ranks import FILES, check_runs, load

from murcl_tpu_torch import train_MuRCL
from murcl_tpu_torch.preprocess.heatmaps import AttentionScorer


def _murcl(ds, base, stage, *extra):
    return train_MuRCL.main(
        ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
         "--device", "cpu", "--epochs", "1", "--ppo_epochs", "1", "--batch_size", "4",
         "--data_repeat", "2", "--feat_size", "16", "--T", "3", "--train_stage", str(stage),
         "--base_save_dir", str(base), *extra])


@pytest.fixture(scope="module")
def murcl_runs(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("murcl")
    return [_murcl(synthetic_dataset, base, stage, "--dp_devices", "2") for stage in (1, 2, 3)]


def test_murcl_cli_stages_on_two_ranks(murcl_runs, synthetic_dataset, tmp_path):
    runs = check_runs(murcl_runs, FILES)
    assert all(k.startswith("encoder.") for k in load(runs[2])["model_state_dict"])
    # dp stage 1 -> single-process stage 2 -> dp stage 3
    single = _murcl(synthetic_dataset, tmp_path, 2, "--save_dir", "single/stage_2",
                    "--checkpoint", str(runs[0] / "model_best.pth.tar"))
    assert "rank_launches" not in single
    for k, v in load(runs[0])["model_state_dict"].items():
        assert torch.equal(v, load(single["save_dir"])["model_state_dict"][k]), k
    back = _murcl(synthetic_dataset, tmp_path, 3, "--save_dir", "dp/stage_3", "--checkpoint",
                  str(Path(single["save_dir"]) / "model_best.pth.tar"), "--dp_devices", "2")
    assert {p.name for p in Path(back["save_dir"]).iterdir()} == FILES
    assert math.isfinite(back["best_loss"])
    # the heatmap scorer takes the dp run's CLAM_SB aggregator
    ckpt = load(runs[2])["model_state_dict"]
    scorer = AttentionScorer(dim_patch=synthetic_dataset["dim"], num_classes=128,
                             checkpoint=str(runs[2] / "model_best.pth.tar"), device="cpu")
    loaded = {k: v for k, v in scorer.model.state_dict().items()
              if not k.startswith("classifiers.")}
    assert loaded and all(torch.equal(v, ckpt[f"encoder.{k}"]) for k, v in loaded.items())


def test_streaming_on_two_ranks_writes_the_same_files(murcl_runs, synthetic_dataset, tmp_path):
    stream = _murcl(synthetic_dataset, tmp_path / "murcl", 1, "--dp_devices", "2",
                    "--streaming")
    resident = Path(murcl_runs[0]["save_dir"])
    assert (Path(stream["save_dir"]) / "losses.csv").read_text() == \
        (resident / "losses.csv").read_text()
