"""Checkpoints in the reference layout (``murcl_tpu/engine/checkpoint.py``).

Every epoch writes ``checkpoint.pth.tar`` with ``torch.save`` -- a dict
``{epoch, model_state_dict, fc, optimizer, ppo_optimizer, policy}`` whose
``model_state_dict`` is the ``CL`` wrapper's (keys under ``encoder.``) --
and copies it to ``model_best.pth.tar`` on improvement.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch


def save_checkpoint(save_dir, epoch: int, model, fc, optimizer=None,
                    is_best: bool = False, filename: str = "checkpoint.pth.tar") -> Path:
    state = {
        "epoch": epoch,
        "model_state_dict": model.state_dict(),
        "fc": fc.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "ppo_optimizer": None,
        "policy": None,
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
