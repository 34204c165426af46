"""Loss helpers of the supervised engine (counterpart of ``murcl_tpu/engine/losses.py``).

Single-device: the JAX package's ``axis_name`` (a global mean across a data
mesh) comes with the multi-device slice (ROADMAP queue 1, slice 5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_mean(x, valid):
    """Mean of ``x`` over the rows where ``valid`` (B,) is true; 0 when no
    row is valid."""
    w = valid.to(x.dtype)
    return (x * w).sum() / w.sum().clamp_min(1.0)


def cross_entropy(logits, labels, valid):
    """Torch ``CrossEntropyLoss`` (mean over the batch) restricted to the
    ``valid`` rows, so a padded last batch counts only its real slides."""
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None].long())[:, 0]
    return masked_mean(nll, valid)


def cosine_similarity(a, b, eps: float = 1e-8):
    """Row-wise cosine similarity with each norm clamped at ``eps``, the JAX
    formula (``murcl_tpu/engine/losses.py:48``): the MuRCL reward."""
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return (a * b).sum(dim=-1) / (na * nb)


def label_confidence(logits, labels):
    """Softmax probability of the true class over the last axis: the
    supervised reward ``confidence_t - confidence_{t-1}``. ``logits
    (..., B, C)``, ``labels (B,)``; returns ``(..., B)``."""
    probs = torch.softmax(logits, dim=-1)
    idx = labels.long().expand(probs.shape[:-1])[..., None]
    return probs.gather(-1, idx)[..., 0]
