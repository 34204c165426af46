"""Driver plumbing (counterpart of ``murcl_tpu/drivers/common.py``): the
reference save-dir scheme and the per-epoch batch order."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np


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


def epoch_batches(num_slides: int, num_data: int, batch_size: int,
                  rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Yield the slide ids ``(B,)`` of each batch of one epoch: one shuffled
    order consumed ``num_data`` times with wraparound. MuRCL fires only on
    full batches, so a partial last batch is dropped (the JAX package's
    ``drop_partial=True``; the padded batch the supervised driver needs
    comes with that slice)."""
    order = rng.permutation(num_slides)
    seq = order[np.arange(num_data) % num_slides]
    for i in range(num_data // batch_size):
        yield seq[i * batch_size:(i + 1) * batch_size].astype(np.int64)
