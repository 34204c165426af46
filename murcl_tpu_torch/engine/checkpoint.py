"""Checkpoints in the reference layout (``murcl_tpu/engine/checkpoint.py``).

Every epoch (MuRCL) or every best epoch (RLMIL with ``--save_model``)
writes ``checkpoint.pth.tar`` with ``torch.save`` -- a dict ``{epoch,
model_state_dict, fc, optimizer, ppo_optimizer, policy}`` -- and copies it to
``model_best.pth.tar`` on improvement. A MuRCL checkpoint's
``model_state_dict`` is the ``CL`` wrapper's (keys under ``encoder.``); an
RLMIL one is the bare aggregator's. :func:`transfer_state` is the
``strict=False`` surgery that moves weights between the two.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch


def save_checkpoint(save_dir, epoch: int, model, fc, optimizer=None, ppo=None,
                    is_best: bool = False, filename: str = "checkpoint.pth.tar") -> Path:
    """``ppo`` (a :class:`~murcl_tpu_torch.models.rlmil.PPO`) adds ``policy``
    and ``ppo_optimizer``."""
    state = {
        "epoch": epoch,
        "model_state_dict": model.state_dict(),
        "fc": fc.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "ppo_optimizer": ppo.optimizer.state_dict() if ppo is not None else None,
        "policy": ppo.policy.state_dict() if ppo is not None else None,
    }
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / filename
    torch.save(state, path)
    if is_best:
        shutil.copyfile(path, save_dir / "model_best.pth.tar")
    return path


def load_checkpoint(path, map_location="cpu") -> dict:
    """Load a checkpoint this package wrote (tensors and plain containers)."""
    return torch.load(path, map_location=map_location, weights_only=True)


_GROUP = "instance_classifiers."  # one stacked leaf in the JAX package
# CLAM_SB's gated attention net without the Dropout before it (the reference
# builds that Dropout only when dropout is on)
_GATES_DROPOUT_OFF = ("attention_net.2.attention_a.0.", "attention_net.2.attention_b.0.",
                      "attention_net.2.attention_c.")


def transfer_state(module: torch.nn.Module, state_dict: dict, verbose: bool = True) -> list:
    """Load the entries of ``state_dict`` that match ``module`` by name and
    shape; the rest of ``module`` keeps its fresh init. ``module.`` prefixes
    are stripped, and ``encoder.`` too when every key carries it (the ``CL``
    wrapper). Returns, and prints, what was skipped (reference
    ``train_RLMIL.py:124-135``; ``murcl_tpu/engine/checkpoint.py:83-115``).

    A CLAM_SB saved with dropout off holds its gated attention net at
    ``attention_net.2``; with no ``attention_net.3.`` key in the source, those
    keys load as ``attention_net.3.*``, the port's layout, as
    ``murcl_tpu/engine/torch_import.py:146`` reads either layout.

    CLAM's ``instance_classifiers.*`` load as one group, as the JAX package's
    stacked ``(C, L1, 2)`` leaf does: when the source's classifiers differ in
    count or shape from the module's (a 128-class MuRCL checkpoint into a
    2-class aggregator), the whole group keeps its fresh init and is reported
    as one skipped entry."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    if sd and all(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items()}
    if not any(k.startswith("attention_net.3.") for k in sd):
        sd = {"attention_net.3." + k[len("attention_net.2."):]
              if k.startswith(_GATES_DROPOUT_OFF) else k: v for k, v in sd.items()}
    own = module.state_dict()
    merged, skipped = dict(own), []
    group = {k: v for k, v in own.items() if k.startswith(_GROUP)}
    src_group = {k: v for k, v in sd.items() if k.startswith(_GROUP)}
    if group and (group.keys() != src_group.keys()
                  or any(src_group[k].shape != v.shape for k, v in group.items())):
        skipped.append(f"{_GROUP[:-1]} (count or shape: {len(group) // 2} classifiers, "
                       f"{len(src_group) // 2} in source)")
        sd = {k: v for k, v in sd.items() if not k.startswith(_GROUP)}
        own = {k: v for k, v in own.items() if not k.startswith(_GROUP)}
    for k, v in own.items():
        if k not in sd:
            skipped.append(f"{k} (missing in source)")
        elif sd[k].shape != v.shape:
            skipped.append(f"{k} (shape {tuple(v.shape)} != {tuple(sd[k].shape)})")
        else:
            merged[k] = sd[k]
    module.load_state_dict(merged)
    if verbose and skipped:
        print(f"transfer_state: kept fresh init for {len(skipped)} entries:")
        for s in skipped[:20]:
            print(f"  - {s}")
    return skipped
