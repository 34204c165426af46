"""Bag-level mixup (counterpart of ``murcl_tpu/ops/mixup.py`` and of
``murcl_tpu/ops/compact_pallas.py`` ``mixup_rows``).

Per bag: ``lam_i = alpha + U[0,1) * (1 - alpha)`` and a random permutation
of the batch; ``out_i = lam_i * x_i + (1 - lam_i) * x[perm[i]]``. Two
roundings of that expression exist, and each call site uses the one its JAX
counterpart uses:

- :func:`apply_mix` and :func:`mixup_rows` take ``1 - lam`` in f32 before
  the cast to ``x.dtype``, as the TPU kernels do. CLAM's fused trunk kernel
  (:mod:`murcl_tpu_torch.ops.attention`) folds this mix in; ABMIL's batched
  stage-1 rollout runs :func:`mixup_rows` (K6, ``csrc/mixup.cu``) on its own.
- :func:`mixup_ref` takes ``1 - lam`` in ``x.dtype``, the JAX ``mixup``
  expression, which the JAX sequential rollout uses for a non-fused arch.

In f32 the two are identical; in bf16 they differ by up to one ulp.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda


def mixup_factors(generator: torch.Generator, b: int, alpha: float):
    """Draw ``(lam (b,) float32, perm (b,) int64)`` on the generator's device."""
    dev = generator.device
    lam = alpha + torch.rand(b, generator=generator, device=dev) * (1.0 - alpha)
    perm = torch.randperm(b, generator=generator, device=dev)
    return lam, perm


def apply_mix(x, perm, lam):
    """``lam_i * x_i + (1 - lam_i) * x[perm_i]`` with ``1 - lam`` taken in f32
    before the cast to ``x.dtype``, as the kernels compute it (JAX
    ``apply_mix``, ``murcl_tpu/ops/mixup.py:31``)."""
    lam32 = lam.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    return lam32.to(x.dtype) * x + (1.0 - lam32).to(x.dtype) * x[perm]


def mixup_ref(x, perm, lam):
    """The JAX ``mixup`` expression (``murcl_tpu/ops/mixup.py:47-54``):
    ``lam`` cast to ``x.dtype`` first, so ``1 - lam`` is taken in ``x.dtype``."""
    lam_b = lam.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return lam_b * x + (1.0 - lam_b) * x[perm]


def _mixup_rows_cuda(x, perm_abs, lam):
    name = "mixup_rows"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: bags must be float32 or bfloat16")
    if perm_abs.shape != x.shape[:1] or lam.shape != x.shape[:1]:
        raise ValueError(f"{name}: perm_abs and lam must be ({x.shape[0]},)")
    x = x.contiguous()
    perm = perm_abs.to(torch.int64).contiguous()
    lam32 = lam.to(torch.float32).contiguous()
    _cuda.require_cuda(name, x, perm, lam32)
    out = torch.empty_like(x)
    per_bag = x[0].numel() if x.shape[0] else 0
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
              and (per_bag * x.element_size()) % 16 == 0)
    if x.shape[0]:
        err = _cuda.library().murcl_mixup_rows(
            int(x.dtype == torch.bfloat16), x.data_ptr(), perm.data_ptr(), lam32.data_ptr(),
            out.data_ptr(), x.shape[0], per_bag, vec, _cuda.stream())
        _cuda.check(err, name)
        _cuda.LAUNCHES["mixup_rows"] += 1
    return out


def mixup_rows(x, perm_abs, lam):
    """Bag-level mixup over ``x (B, ...)``: ``lam_i * x_i + (1 - lam_i) *
    x[perm_abs[i]]``, the expression of :func:`apply_mix`. ``perm_abs (B,)``
    holds absolute bag indices (the engine offsets each (step, view) group's
    permutation), ``lam (B,)``. No gradient: the bags are data. CPU tensors
    take :func:`apply_mix`; CUDA tensors always launch K6 (``csrc/mixup.cu``)
    into a new tensor."""
    if x.device.type == "cpu":
        return apply_mix(x, perm_abs, lam)
    return _mixup_rows_cuda(x, perm_abs, lam)
