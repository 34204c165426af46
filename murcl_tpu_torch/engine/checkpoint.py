"""Checkpoints in the reference layout (``murcl_tpu/engine/checkpoint.py``).

Every epoch (MuRCL) or every best epoch (RLMIL with ``--save_model``)
writes ``checkpoint.pth.tar`` with ``torch.save`` -- a dict ``{epoch,
model_state_dict, fc, optimizer, ppo_optimizer, policy}`` -- and copies it to
``model_best.pth.tar`` on improvement. A MuRCL checkpoint's
``model_state_dict`` is the ``CL`` wrapper's (keys under ``encoder.``); an
RLMIL one is the bare aggregator's. :func:`transfer_state` is the
``strict=False`` surgery that moves weights between the two.

:func:`load_checkpoint` also reads the JAX package's checkpoints
(``murcl_tpu/engine/checkpoint.py:35-77``): a pickle of numpy trees with
``"format": "murcl_tpu/v1"``. A restricted unpickler takes numpy's arrays,
stands a stub in for every optax, flax, jax and chex class of the optimizer
states, and refuses any other global, so the read needs none of those
packages; the trees become the port's ``state_dict`` layout.
"""

from __future__ import annotations

import importlib
import pickle
import shutil
from pathlib import Path

import torch

from murcl_tpu_torch.engine.weights import jax_tree_arch, params_from_jax, policy_from_jax


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


JAX_FORMAT = "murcl_tpu/v1"
# numpy's array reconstruction, under numpy 2's (numpy._core) and numpy 1's
# (numpy.core) module names
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct")}
_STUBBED = ("optax", "flax", "jax", "chex")


class _Stub:
    """Stands in for an optax/flax/jax/chex object of a JAX checkpoint's
    optimizer states, which the reader drops."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            if module == "numpy":
                return getattr(importlib.import_module("numpy"), name)
            try:
                core = importlib.import_module("numpy._core.multiarray")
            except ImportError:
                core = importlib.import_module("numpy.core.multiarray")
            return getattr(core, name)
        if module.split(".")[0] in _STUBBED:
            return type(name, (_Stub,), {"__module__": module})
        raise pickle.UnpicklingError(f"global {module}.{name} is not allowed in a checkpoint")


def _load_jax(path, map_location) -> dict:
    """A JAX package checkpoint: ``model_state_dict``, ``fc`` and ``policy``
    in the port's layouts, converted by the aggregator the tree's leaves
    show; ``optimizer`` and ``ppo_optimizer`` are ``None``, since optax's
    moments do not map onto ``torch.optim`` (the JAX drivers' ``--resume``
    restores them, so a caller that resumes says what it drops), and
    ``format`` is kept to tell such a dict from a torch file's."""
    with open(path, "rb") as fp:
        state = _JaxUnpickler(fp).load()
    if not isinstance(state, dict) or state.get("format") != JAX_FORMAT:
        raise ValueError(f"{path} is neither a torch file nor a {JAX_FORMAT} checkpoint")
    model, fc = params_from_jax(state["model_state_dict"], state["fc"],
                                arch=jax_tree_arch(state["model_state_dict"]))
    policy = policy_from_jax(state["policy"]) if state.get("policy") is not None else None
    move = lambda sd: {k: v.to(map_location) for k, v in sd.items()}  # noqa: E731
    return {"epoch": state["epoch"], "model_state_dict": move(model), "fc": move(fc),
            "optimizer": None, "ppo_optimizer": None,
            "policy": move(policy) if policy is not None else None, "format": JAX_FORMAT}


def load_checkpoint(path, map_location="cpu") -> dict:
    """Load a checkpoint: a ``torch.save`` file this package wrote (a zip,
    magic ``PK``: tensors and plain containers), or a JAX package pickle
    (any aggregator: its tree names its arch)."""
    with open(path, "rb") as fp:
        magic = fp.read(2)
    if magic == b"PK":
        return torch.load(path, map_location=map_location, weights_only=True)
    return _load_jax(path, map_location)


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
