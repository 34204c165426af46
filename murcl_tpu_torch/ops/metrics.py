"""Classification metrics in numpy (counterpart of ``murcl_tpu/ops/metrics.py``).

``get_metrics`` returns ``(acc, auc, precision, recall, f1)`` as the JAX
package computes them with scikit-learn, without it:

- ROC-AUC on softmax probabilities: binary on ``probs[:, 1]``, multiclass
  one-vs-rest with a macro mean. Each AUC is the Mann-Whitney rank
  statistic with average ranks for ties, which is what ``roc_auc_score``
  computes.
- Precision, recall and F1 of the argmax predictions: binary (positive
  class 1), or a macro mean over the labels present in targets or
  predictions for more than two classes, with ``zero_division=0``.

``get_score`` is the composite ``0.3 acc + 0.3 auc + 0.1 p + 0.1 r + 0.2 f1``.
"""

from __future__ import annotations

import numpy as np


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def accuracy_topk(outputs, targets, topk=(1,)):
    """Top-k accuracy in percent, matching the reference ``accuracy``."""
    outputs = np.asarray(outputs)
    targets = np.asarray(targets).reshape(-1)
    maxk = max(topk)
    pred = np.argsort(-outputs, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(axis=1).sum() / targets.shape[0] for k in topk]


def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both classes among the targets")
    from scipy.stats import rankdata  # here: importing scipy.stats takes seconds

    ranks = rankdata(score)  # average ranks for ties
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _prf(targets: np.ndarray, preds: np.ndarray, label: int):
    tp = float(np.sum((preds == label) & (targets == label)))
    n_pred, n_true = float(np.sum(preds == label)), float(np.sum(targets == label))
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_true if n_true else 0.0
    f1 = 2 * tp / (n_pred + n_true) if n_pred + n_true else 0.0
    return precision, recall, f1


def get_metrics(outputs, targets):
    """``(acc, auc, precision, recall, f1)`` from logits and integer labels."""
    outputs = np.asarray(outputs, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.int64).reshape(-1)
    assert outputs.shape[0] == targets.shape[0]
    num_class = outputs.shape[1]
    preds = outputs.argmax(axis=1)
    acc = float((preds == targets).sum() / targets.shape[0])
    probs = _softmax(outputs)
    if num_class > 2:
        auc = float(np.mean([_binary_auc(targets == c, probs[:, c]) for c in range(num_class)]))
        per_label = [_prf(targets, preds, c) for c in np.union1d(targets, preds)]
        precision, recall, f1 = (float(np.mean(v)) for v in zip(*per_label))
    else:
        auc = _binary_auc(targets == 1, probs[:, 1])
        precision, recall, f1 = _prf(targets, preds, 1)
    return acc, auc, precision, recall, f1


def get_score(acc, auc, precision, recall, f1_score):
    return 0.3 * acc + 0.3 * auc + 0.1 * precision + 0.1 * recall + 0.2 * f1_score
