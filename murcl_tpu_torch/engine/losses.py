"""Loss helpers of the supervised engine (counterpart of ``murcl_tpu/engine/losses.py``).

The batch means take the data-parallel ranks ``dp``
(:class:`~murcl_tpu_torch.parallel.Ranks`), JAX's ``axis_name``: numerator
and count are summed over the ranks, so a rank's loss is the global-batch
loss, and its backward is its local sum over the global count (the count
carries no gradient; the engines sum the ranks' gradients).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from murcl_tpu_torch.parallel import SINGLE, Ranks


def masked_mean(x, valid, dp: Ranks = SINGLE):
    """Mean of ``x`` over the rows where ``valid`` (B,) is true, over every
    rank's rows; 0 when no row is valid."""
    w = valid.to(x.dtype)
    return dp.all_sum((x * w).sum()) / dp.sum(w.sum()).clamp_min(1.0)


def cross_entropy(logits, labels, valid, dp: Ranks = SINGLE):
    """Torch ``CrossEntropyLoss`` (mean over the batch) restricted to the
    ``valid`` rows, so a padded last batch counts only its real slides."""
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None].long())[:, 0]
    return masked_mean(nll, valid, dp)


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
