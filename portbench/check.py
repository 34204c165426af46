"""The numbers that decide ``correct``: what the run under test produced on
its checked steps against the reference on the same draws.

- ``loss``: the largest gap of a step's loss, over the reference's.
- ``grad1``: the worst leaf's gap between the norms of the first gradient
  (the program's as Adam's first moment holds it after step 1; the
  reference's with the same L2 decay), over the reference's norm of that
  leaf or of the median leaf, whichever is larger. A run whose optimizer
  kept no state reads 1.
- ``change``: the median leaf's gap between the norms of the parameters'
  change over the checked steps, as they stand before the next step, over
  the larger of that leaf's and the median leaf's reference norm. Not the
  worst leaf's: Adam divides each element's moment by its own scale, so an
  element whose gradient lies near Adam's epsilon moves by an amount that
  the last bits of its gradient set, on either side; the worst leaf's gap
  then swings from seed to seed by a hundredfold (``PERF.md``). Leaves
  whose loss gradient in the reference is under a thousandth of the median
  leaf's move under Adam by round-off alone (an attention score's bias
  under softmax), and those the loss does not reach (CLAM's classifiers,
  which pretraining never calls) by the decay alone: both are left out.
- ``act`` (stage 3): the largest gap of the policy's mean action, the
  program's from its own states against the reference's from its own.

The median leaf is taken over the leaves the loss reaches.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

# a leaf whose loss gradient is under this share of the median leaf's
# moves by round-off alone
NOUGHT = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys, median: float) -> Dict[str, float]:
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys, median: float) -> float:
    return max(_gaps(prog, ref, keys, median).values())


def readings(run, ref, w0: Dict[str, torch.Tensor], loss_grad1: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
    """``run``: the program's (or the control's) checked steps (``losses``,
    ``grad1``, ``params``, ``means``); ``ref``: the reference's; ``w0``: the
    weights both started from; ``loss_grad1``: the reference's first
    gradient of the loss alone, by leaf (those the loss reaches)."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(run.losses, ref.losses))}
    reached = _norms(loss_grad1)
    med = statistics.median(reached.values())
    g_ref = _norms(ref.grad1)
    med_g = statistics.median(g_ref[k] for k in reached)
    out["grad1"] = 1.0 if run.grad1 is None else _worst(_norms(run.grad1), g_ref, g_ref, med_g)
    moved = [k for k, v in reached.items() if v >= NOUGHT * med]
    d_run = _norms({k: run.params[k].to(w0[k].device) - w0[k] for k in moved})
    d_ref = _norms({k: ref.params[k] - w0[k] for k in moved})
    out["change"] = statistics.median(
        _gaps(d_run, d_ref, moved, statistics.median(d_ref.values())).values())
    if ref.means and ref.means[0] is not None:
        out["act"] = max(float((a.to(b.device) - b).abs().max())
                         for a, b in zip(run.means, ref.means))
    return out


def worst_leaves(run, ref, w0, loss_grad1, top: int = 3) -> Dict[str, list]:
    """The leaves that set ``grad1`` and ``change``, worst first, each with
    its gap and its loss gradient over the median leaf's (the calibration's
    notes), and the leaves left out of ``change``."""
    reached = _norms(loss_grad1)
    med = statistics.median(reached.values())
    g_ref = _norms(ref.grad1)

    def ranked(gaps):
        return [[k, gaps[k], reached.get(k, 0.0) / med]
                for k in sorted(gaps, key=gaps.get, reverse=True)[:top]]

    out = {}
    if run.grad1 is not None:
        out["grad1_leaves"] = ranked(_gaps(_norms(run.grad1), g_ref, g_ref,
                                           statistics.median(g_ref[k] for k in reached)))
    moved = [k for k, v in reached.items() if v >= NOUGHT * med]
    d_run = _norms({k: run.params[k].to(w0[k].device) - w0[k] for k in moved})
    d_ref = _norms({k: ref.params[k] - w0[k] for k in moved})
    out["change_leaves"] = ranked(_gaps(d_run, d_ref, moved, statistics.median(d_ref.values())))
    out["excluded"] = [[k, reached[k] / med] for k in sorted(reached) if k not in moved]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number compared is finite and within its limit."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> str:
    return "\n".join(f"check {k}: {numbers.get(k)!r} (limit {lim!r})" for k, lim in limits.items())

