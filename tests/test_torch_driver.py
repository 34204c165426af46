"""Port's MuRCL CLI at stage 1 end to end on the CPU plain path, and its guards:
unported options raise, importing the port leaves JAX unloaded, and a
kernel launch with no CUDA toolkit raises instead of falling back."""

import csv
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.train_MuRCL import main

REPO = Path(__file__).resolve().parents[1]


def _argv(ds, tmp_path, *extra):
    return ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--data_repeat", "1",
            "--feat_size", "16", "--T", "2", "--base_save_dir", str(tmp_path),
            "--save_dir", "run", *extra]


def test_cli_stage1_one_epoch(synthetic_dataset, tmp_path):
    out = main(_argv(synthetic_dataset, tmp_path))
    run = Path(out["save_dir"])
    for name in ("checkpoint.pth.tar", "model_best.pth.tar", "losses.csv", "results.csv",
                 "args.json"):
        assert (run / name).exists(), name
    with open(run / "losses.csv") as fp:
        rows = list(csv.DictReader(fp))
    assert len(rows) == 1 and math.isfinite(float(rows[0]["train"]))
    ckpt = torch.load(run / "checkpoint.pth.tar", weights_only=True)
    assert ckpt["epoch"] == 1
    assert all(k.startswith("encoder.") for k in ckpt["model_state_dict"])
    # --resume continues from the saved epoch
    out2 = main(_argv(synthetic_dataset, tmp_path, "--epochs", "2", "--exist_ok",
                      "--resume"))
    assert out2["save_dir"] == out["save_dir"]
    assert torch.load(run / "checkpoint.pth.tar", weights_only=True)["epoch"] == 2


# stages 2/3 and ABMIL are ported (tests/test_torch_murcl_stages.py), and so
# are --use_tensorboard and --profile (tests/test_torch_profile_tb.py),
# --policy_conv (tests/test_torch_policy_heads.py) and --streaming
# (tests/test_torch_streaming.py)
@pytest.mark.parametrize("extra", [("--dp_devices", "2")])
def test_unported_flags_raise(synthetic_dataset, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(_argv(synthetic_dataset, tmp_path, *extra))


def test_tpu_only_flags_are_absent(synthetic_dataset, tmp_path):
    with pytest.raises(SystemExit):
        main(_argv(synthetic_dataset, tmp_path, "--remat", "none"))


def test_import_leaves_jax_out():
    code = ("import sys, murcl_tpu_torch.drivers.murcl, murcl_tpu_torch.train_MuRCL; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'pandas', 'yaml', 'sklearn', 'murcl_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernels_without_nvcc_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.library()
