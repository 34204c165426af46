"""Bag-level mixup (counterpart of ``murcl_tpu/ops/mixup.py``).

Per bag: ``lam_i = alpha + U[0,1) * (1 - alpha)`` and a random permutation
of the batch; ``out_i = lam_i * x_i + (1 - lam_i) * x[perm[i]]``. On the
main path the mix runs inside the fused trunk kernel
(:mod:`murcl_tpu_torch.ops.attention`); :func:`apply_mix` is the same
expression for the plain path.
"""

from __future__ import annotations

import torch


def mixup_factors(generator: torch.Generator, b: int, alpha: float):
    """Draw ``(lam (b,) float32, perm (b,) int64)`` on the generator's device."""
    dev = generator.device
    lam = alpha + torch.rand(b, generator=generator, device=dev) * (1.0 - alpha)
    perm = torch.randperm(b, generator=generator, device=dev)
    return lam, perm


def apply_mix(x, perm, lam):
    """``lam_i * x_i + (1 - lam_i) * x[perm_i]`` with ``1 - lam`` taken in f32
    before the cast to ``x.dtype``, as the fused kernel computes it."""
    lam32 = lam.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    return lam32.to(x.dtype) * x + (1.0 - lam32).to(x.dtype) * x[perm]
