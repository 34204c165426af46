"""Driver plumbing (counterpart of ``murcl_tpu/drivers/common.py``): the
reference save-dir schemes, the per-epoch batch order, epoch metrics and
the policy loading both drivers share."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from murcl_tpu_torch.engine.checkpoint import transfer_state
from murcl_tpu_torch.ops.metrics import get_metrics


def murcl_save_dir(args) -> str:
    """MuRCL pretraining run dir (``train_MuRCL.py:18-55`` of the reference)."""
    murcl = (f"T{args.T}_pd{args.projection_dim}_as{args.action_std}_pg{args.ppo_gamma}"
             f"_tau{args.temperature}_alpha{args.alpha}")
    if args.arch == "ABMIL":
        arch_setting = f"L{args.model_dim}_D{args.D}_dpt{args.dropout}"
    elif args.arch == "CLAM_SB":
        arch_setting = f"size_{args.size_arg}_ks_{args.k_sample}"
    else:
        raise ValueError(args.arch)
    exp = "exp" if args.save_dir_flag is None else f"exp_{args.save_dir_flag}"
    return str(
        Path(args.base_save_dir) / f"{args.dataset}_np_{args.feat_size}" / "MuRCL" / murcl
        / args.arch / arch_setting / exp / f"seed{args.seed}" / f"stage_{args.train_stage}")


def rlmil_save_dir(args) -> str:
    """Downstream RLMIL run dir (``train_RLMIL.py:20-57`` of the reference)."""
    rl = (f"T{args.T}_as{args.action_std}_pg{args.ppo_gamma}_phd{args.policy_hidden_dim}"
          f"_fhd{args.fc_hidden_dim}")
    if args.arch == "ABMIL":
        arch_setting = f"L{args.L}_D{args.D}_dpt{args.dropout}"
    elif args.arch == "DSMIL":
        arch_setting = "default"
    elif args.arch == "CLAM_SB":
        arch_setting = f"size_{args.size_arg}_ks_{args.k_sample}_bw_{args.bag_weight}"
    else:
        raise ValueError(args.arch)
    exp = "exp" if args.save_dir_flag is None else f"exp_{args.save_dir_flag}"
    return str(
        Path(args.base_save_dir) / f"{args.dataset}_np_{args.feat_size}" / "RLMIL" / rl
        / args.arch / arch_setting / args.train_method / exp / f"seed{args.seed}"
        / f"stage_{args.train_stage}")


def load_policy(ppo, state_dict) -> None:
    """Load ``state_dict`` into the PPO's policy by :func:`transfer_state`,
    then copy it into ``policy_old``."""
    transfer_state(ppo.policy, state_dict)
    ppo.policy_old.load_state_dict(ppo.policy.state_dict())


def epoch_batches(num_slides: int, num_data: int, batch_size: int, rng: np.random.Generator,
                  drop_partial: bool) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(slide_ids (B,), valid (B,))`` per batch of one epoch: one
    shuffled order consumed ``num_data`` times with wraparound. MuRCL fires
    only on full batches (``drop_partial=True``); RLMIL also fires the last
    partial batch, padded to ``batch_size`` with its last id and a ``valid``
    mask."""
    order = rng.permutation(num_slides)
    seq = order[np.arange(num_data) % num_slides]
    n_full = num_data // batch_size
    for i in range(n_full):
        yield seq[i * batch_size:(i + 1) * batch_size].astype(np.int64), \
            np.ones(batch_size, dtype=bool)
    rem = num_data - n_full * batch_size
    if rem and not drop_partial:
        tail = seq[n_full * batch_size:]
        pad = np.full(batch_size - rem, tail[-1])
        yield np.concatenate([tail, pad]).astype(np.int64), np.arange(batch_size) < rem


class EpochOutputs:
    """Final-step logits and labels of an epoch's batches, for its metrics."""

    def __init__(self):
        self.logits: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def update(self, logits, labels, valid: Optional[np.ndarray] = None) -> None:
        logits, labels = np.asarray(logits), np.asarray(labels)
        if valid is not None:
            logits, labels = logits[valid], labels[valid]
        self.logits.append(logits)
        self.labels.append(labels)

    def metrics(self):
        logits, labels = np.concatenate(self.logits), np.concatenate(self.labels)
        return get_metrics(logits, labels), logits, labels
