"""Optimizers with the reference's two parameter groups
(counterpart of ``murcl_tpu/engine/optim.py``).

The aggregator trains at ``backbone_lr`` and the GRU head at ``fc_lr``
(groups ``model`` and ``fc``). Weight decay is torch's classic L2, added to
the gradient before the moments (not AdamW). Schedulers step per epoch and
only after ``--warmup`` epochs; :func:`set_learning_rates` writes the
epoch's rates into the groups.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def make_optimizer(model: torch.nn.Module, fc: torch.nn.Module, optimizer: str = "Adam",
                   backbone_lr: float = 1e-4, fc_lr: float = 1e-4, beta1: float = 0.9,
                   beta2: float = 0.999, momentum: float = 0.9, nesterov: bool = True,
                   wdecay: float = 1e-5) -> torch.optim.Optimizer:
    groups = [{"params": list(model.parameters()), "lr": backbone_lr, "name": "model"},
              {"params": list(fc.parameters()), "lr": fc_lr, "name": "fc"}]
    if optimizer == "Adam":
        return torch.optim.Adam(groups, betas=(beta1, beta2), eps=1e-8,
                                weight_decay=wdecay)
    if optimizer == "SGD":
        return torch.optim.SGD(groups, momentum=momentum, nesterov=nesterov,
                               weight_decay=wdecay)
    raise NotImplementedError(f"optimizer {optimizer!r}")


def set_learning_rates(opt: torch.optim.Optimizer, backbone_lr: float, fc_lr: float) -> None:
    lrs = {"model": backbone_lr, "fc": fc_lr}
    for group in opt.param_groups:
        group["lr"] = lrs[group["name"]]


def lr_schedule_factory(scheduler: Optional[str], base_lr: float, epochs: int,
                        warmup: int = 0, step_size: int = 7, step_gamma: float = 0.1,
                        eta_min: float = 1e-6):
    """Epoch -> lr, replicating torch's StepLR / CosineAnnealingLR stepped
    once per epoch from ``epoch >= warmup`` on."""
    if scheduler is None:
        return lambda epoch: base_lr

    def steps_done(epoch: int) -> int:
        return max(0, epoch - warmup)

    if scheduler == "StepLR":
        return lambda epoch: base_lr * (step_gamma ** (steps_done(epoch) // step_size))
    if scheduler == "CosineAnnealingLR":
        t_max = max(1, epochs - warmup)

        def cosine(epoch: int) -> float:
            t = steps_done(epoch)
            return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2

        return cosine
    raise ValueError(f"scheduler {scheduler!r}")
