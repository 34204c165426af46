"""The port reads the JAX package's checkpoints.

``murcl_tpu.engine.checkpoint.save_checkpoint`` writes a pickle of numpy
trees (``"format": "murcl_tpu/v1"``) that also holds optax's optimizer
states. For CLAM_SB gated and ungated, ABMIL and DSMIL, each with an Adam
state and a PPO state, the port's ``load_checkpoint`` reads it in a
subprocess where ``jax``, ``jaxlib``, ``flax``, ``optax`` and ``chex``
cannot be imported, and its ``model_state_dict``, ``fc`` and ``policy``
equal ``params_from_jax`` / ``policy_from_jax`` of the trees bitwise; the
optimizer entries are ``None``. A pickle naming a foreign global is
refused without running it, and a pickle of another format too.
``train_RLMIL --checkpoint_pretrained`` takes a JAX pickle: stage 1 loads
its aggregator, stage 2 its policy, and both run on the CPU;
``train_MuRCL --resume`` goes on from a JAX run's checkpoint and says that
the optimizer states start fresh, while a resume from the port's own file
loads strictly.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
from murcl_tpu.engine import RolloutConfig as JaxConfig
from murcl_tpu.engine import SupervisedEngine as JaxEngine
from murcl_tpu.engine.checkpoint import save_checkpoint
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.dsmil import MILNet as JaxMILNet
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu_torch import train_MuRCL, train_RLMIL
from murcl_tpu_torch.drivers import murcl, rlmil
from murcl_tpu_torch.engine import checkpoint as ckpt_mod
from murcl_tpu_torch.engine.checkpoint import load_checkpoint
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax

REPO = Path(__file__).resolve().parents[1]
DIM, B, FEAT, K, HID, PHID = 32, 2, 8, 5, 16, 16
BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex")


def _aggregator(arch, gated=True, classes=2):
    """``(JAX module, bag-embedding width)``; CLAM_SB at the "small" size."""
    if arch == "ABMIL":
        return JaxABMIL(dim_in=DIM, L=DIM, D=16, dim_out=classes), DIM
    if arch == "DSMIL":
        return JaxMILNet(dim_feat=DIM, num_classes=classes), DIM
    return (JaxCLAM(in_dim=DIM, gate=gated, size_arg="small", k_sample=2, n_classes=classes,
                    subtyping=True), jax_clam.SIZE_DICT["small"][0])


def _write(path, arch, gated=True, seed=0, classes=2, stage=3):
    """A JAX checkpoint (model, fc, Adam state, and from stage 2 on a PPO
    state) at ``path``; returns its ``(params, ppo params or None)``."""
    model, width = _aggregator(arch, gated, classes)
    ppo = (JaxPPO(state_dim=width, hidden_state_dim=PHID, action_size=K, action_std=0.5)
           if stage != 1 else None)
    engine = JaxEngine(JaxConfig(arch=arch, T=2, feat_size=FEAT, num_clusters=K,
                                 max_patches=64, train_stage=stage, remat="none"),
                       model, JaxFullLayer(feature_num=width, hidden_state_dim=HID,
                                           class_num=classes),
                       ppo=ppo, tx=jax_make_optimizer("Adam"))
    params = engine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)),
                                jnp.zeros((B,), jnp.int32))
    pstate = ppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, width))) if ppo else None
    save_checkpoint(path.parent, 7, engine.init_state(params), pstate, filename=path.name)
    return params, pstate.params if pstate else None


def _read_without_jax(path, out):
    code = (f"import sys\nfor name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
            "import torch\nfrom murcl_tpu_torch.engine.checkpoint import load_checkpoint\n"
            f"torch.save(load_checkpoint({str(path)!r}), {str(out)!r})\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            f"m.split('.')[0] in {BLOCKED + ('murcl_tpu',)!r}]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return torch.load(out, weights_only=True)


def _equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("arch, gated", [("CLAM_SB", True), ("CLAM_SB", False),
                                         ("ABMIL", None), ("DSMIL", None)])
def test_jax_checkpoint_reads_without_jax(tmp_path, arch, gated):
    path = tmp_path / "checkpoint.pth.tar"
    params, policy = _write(path, arch, gated)
    with open(path, "rb") as fp:  # the optimizer states reference optax's classes
        assert b"optax" in fp.read()
    ck = _read_without_jax(path, tmp_path / "read.pt")
    model, fc = params_from_jax(params["model"], params["fc"], arch=arch)
    _equal(ck["model_state_dict"], model)
    _equal(ck["fc"], fc)
    _equal(ck["policy"], policy_from_jax(policy))
    assert ck["optimizer"] is None and ck["ppo_optimizer"] is None and ck["epoch"] == 7
    if arch == "CLAM_SB":
        assert any(".attention_b." in k for k in model) == gated


class _Exploit:
    def __reduce__(self):
        return (os.system, ("echo ran",))


def test_foreign_global_and_other_format_are_refused(tmp_path):
    bad = tmp_path / "bad.pth.tar"
    bad.write_bytes(pickle.dumps({"format": "murcl_tpu/v1", "model_state_dict": _Exploit()}))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_checkpoint(bad)
    other = tmp_path / "other.pth.tar"
    other.write_bytes(pickle.dumps({"format": "murcl_tpu/v0", "epoch": 1}))
    with pytest.raises(ValueError, match="neither a torch file"):
        load_checkpoint(other)
    good = tmp_path / "good.pth.tar"
    _write(good, "ABMIL")
    # numpy 1 and numpy 2 name the array reconstruction differently
    with open(good, "rb") as fp:
        unpickler = ckpt_mod._JaxUnpickler(fp)
        assert (unpickler.find_class("numpy.core.multiarray", "_reconstruct")
                is unpickler.find_class("numpy._core.multiarray", "_reconstruct"))


def test_train_rlmil_finetunes_from_jax_pickle(synthetic_dataset, tmp_path):
    pre = tmp_path / "jax" / "model_best.pth.tar"
    params, policy = _write(pre, "CLAM_SB", seed=3)

    def argv(stage, *extra):
        return ["--data_csv", synthetic_dataset["data_csv"], "--data_split_json",
                synthetic_dataset["data_split_json"], "--device", "cpu", "--feat_size", "16",
                "--T", "2", "--base_save_dir", str(tmp_path / "rlmil"), "--train_method",
                "finetune", "--train_stage", str(stage), "--epochs", "1", "--ppo_epochs", "1",
                "--batch_size", "3", "--save_model", "--k_sample", "2", "--policy_hidden_dim",
                str(PHID), "--checkpoint_pretrained", str(pre), *extra]

    model, _ = params_from_jax(params["model"], arch="CLAM_SB")
    s = rlmil.setup(train_RLMIL.parse_args(argv(1)))
    _equal(s.model.state_dict(), model)
    out = train_RLMIL.main(argv(1, "--exist_ok"))
    assert all(np.isfinite(v) for v in out["final"])
    s = rlmil.setup(train_RLMIL.parse_args(argv(2)))
    _equal(s.ppo.policy.state_dict(), policy_from_jax(policy))
    out = train_RLMIL.main(argv(2, "--exist_ok"))
    assert Path(out["save_dir"]).name == "stage_2"
    assert all(np.isfinite(v) for v in out["final"])


def _murcl_argv(synthetic_dataset, tmp_path, epochs, dim=DIM):
    return ["--data_csv", synthetic_dataset["data_csv"], "--data_split_json",
            synthetic_dataset["data_split_json"], "--device", "cpu", "--feat_size", "16",
            "--T", "2", "--batch_size", "2", "--data_repeat", "1", "--epochs", str(epochs),
            "--arch", "ABMIL", "--model_dim", str(dim), "--D", "16", "--projection_dim", "8",
            "--fc_hidden_dim", str(HID), "--base_save_dir", str(tmp_path), "--save_dir", "run",
            "--exist_ok", "--resume"]


def test_murcl_resumes_from_jax_pickle(synthetic_dataset, tmp_path, capsys):
    """``train_MuRCL --resume`` over a JAX run's ``checkpoint.pth.tar``: the
    CL wrapper's encoder takes the bare aggregator tree, the head its fc,
    training goes on from the saved epoch, and the run says that the
    optimizer states start fresh."""
    argv = _murcl_argv(synthetic_dataset, tmp_path, 8)
    params, _ = _write(tmp_path / "run" / "checkpoint.pth.tar", "ABMIL", classes=8, stage=1)
    model, fc = params_from_jax(params["model"], params["fc"], arch="ABMIL")
    s = murcl.setup(train_MuRCL.parse_args(argv))
    assert "optimizer's and the PPO optimizer's states start fresh" in capsys.readouterr().out
    _equal(s.model.encoder.state_dict(), model)
    _equal(s.fc.state_dict(), fc)
    assert s.start_epoch == 7
    out = train_MuRCL.main(argv)
    assert np.isfinite(out["best_loss"])


def test_murcl_resume_of_a_port_file_is_strict(synthetic_dataset, tmp_path):
    """A resume from the port's own ``checkpoint.pth.tar`` restores the
    weights and the optimizer exactly, and refuses a model of another
    width instead of keeping its fresh init."""
    out = train_MuRCL.main(_murcl_argv(synthetic_dataset, tmp_path, 1))
    assert np.isfinite(out["best_loss"])
    saved = torch.load(tmp_path / "run" / "checkpoint.pth.tar", weights_only=True)
    s = murcl.setup(train_MuRCL.parse_args(_murcl_argv(synthetic_dataset, tmp_path, 2)))
    _equal(s.model.state_dict(), saved["model_state_dict"])
    assert s.start_epoch == 1 and s.optimizer.state_dict()["state"]
    with pytest.raises(RuntimeError, match="size mismatch"):
        murcl.setup(train_MuRCL.parse_args(_murcl_argv(synthetic_dataset, tmp_path, 2,
                                                        dim=DIM // 2)))
