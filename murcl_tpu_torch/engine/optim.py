"""Optimizers with the reference's two parameter groups
(counterpart of ``murcl_tpu/engine/optim.py``).

The aggregator trains at ``backbone_lr`` and the GRU head at ``fc_lr``
(groups ``model`` and ``fc``). Weight decay is torch's classic L2, added to
the gradient before the moments (not AdamW). Schedulers step per epoch and
only after ``--warmup`` epochs; :func:`set_learning_rates` writes the
epoch's rates into the groups. Linear evaluation
(:func:`freeze_for_linear_eval`) freezes the aggregator but its heads; frozen
parameters stay out of the optimizer, so they take no step and no decay,
like optax's ``set_to_zero`` group in the JAX package.

The engines step through :func:`step`: a stepped parameter without a
gradient (a dead head, such as CLAM's ``classifiers``) gets a zero one
first, so the L2 decay and Adam's moments move it as optax's
``add_decayed_weights`` + ``scale_by_adam`` move every leaf of its group;
``torch.optim`` would skip it. Under data parallelism the gradients are then
summed over the ranks, the zeros too, so every rank steps on the same
numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from murcl_tpu_torch.engine.weights import jax_leaf_path
from murcl_tpu_torch.parallel import SINGLE, Ranks
from murcl_tpu_torch.utils.trace import span

# JAX leaf names that stay trainable under linear eval
# (``murcl_tpu/engine/optim.py:150``)
_LINEAR_EVAL_HEADS = {"fc", "classifiers", "instance_kernel", "instance_bias"}


def make_optimizer(model: torch.nn.Module, fc: torch.nn.Module, optimizer: str = "Adam",
                   backbone_lr: float = 1e-4, fc_lr: float = 1e-4, beta1: float = 0.9,
                   beta2: float = 0.999, momentum: float = 0.9, nesterov: bool = True,
                   wdecay: float = 1e-5) -> torch.optim.Optimizer:
    groups = [{"params": [p for p in model.parameters() if p.requires_grad],
               "lr": backbone_lr, "name": "model"},
              {"params": list(fc.parameters()), "lr": fc_lr, "name": "fc"}]
    # a wholly frozen aggregator (DSMIL under linear eval) leaves its group out
    groups = [g for g in groups if g["params"]]
    if optimizer == "Adam":
        return torch.optim.Adam(groups, betas=(beta1, beta2), eps=1e-8,
                                weight_decay=wdecay)
    if optimizer == "SGD":
        return torch.optim.SGD(groups, momentum=momentum, nesterov=nesterov,
                               weight_decay=wdecay)
    raise NotImplementedError(f"optimizer {optimizer!r}")


def freeze_for_linear_eval(model: torch.nn.Module, arch: str = "CLAM_SB") -> None:
    """Linear evaluation: ``requires_grad_(False)`` on every aggregator
    parameter whose JAX leaf path (:func:`~murcl_tpu_torch.engine.weights.jax_leaf_path`)
    names none of ``fc``, ``classifiers``, ``instance_kernel`` and
    ``instance_bias``, the predicate of ``murcl_tpu/engine/optim.py:141-155``.

    The JAX package departs here from the torch reference
    (``train_RLMIL.py:139-144``, a name test on torch keys): JAX's CLAM names
    its trunk ``fc``, so CLAM's trunk ``attention_net.0`` trains under linear
    eval besides ``classifiers`` and ``instance_classifiers``, and the
    attention net is frozen. The port follows the JAX package. ABMIL's head
    ``fc`` trains too; DSMIL has no such leaf, so its whole aggregator is
    frozen and only the GRU head trains."""
    gated = any(".attention_b." in k for k, _ in model.named_parameters())
    for name, p in model.named_parameters():
        if not _LINEAR_EVAL_HEADS.intersection(jax_leaf_path(name, arch, gated)):
            p.requires_grad_(False)


def fill_missing_grads(params) -> None:
    """Give each of ``params`` that requires grad but has none a zero gradient."""
    for p in params:
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


def step(optimizer: torch.optim.Optimizer, dp: Ranks = SINGLE) -> None:
    """``optimizer.step()`` after :func:`fill_missing_grads` over its groups
    and the sum of the gradients over the ranks ``dp``."""
    with span("murcl.optimizer"):
        params = [p for group in optimizer.param_groups for p in group["params"]]
        fill_missing_grads(params)
        dp.all_reduce_grads(params)
        optimizer.step()


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
