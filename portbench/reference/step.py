"""The reference's MuRCL training steps (stages 1 and 3), on the draws the
benchmark handed to the program.

A stage-1 step selects both views' sub-bags at each of T steps from the
actions, mixes each (step, view) group of B bags by its own permutation and
factors, embeds all ``T * 2 * B`` bags in one aggregator call (bag ``i``'s
dropout is keyed by the step's one seed and ``i``), runs the GRU head over
the steps (each view restarting from zeros at t=0, view 1's carry kept;
from t=1 view 0 takes the carry view 1 wrote, view 1 the one view 0 wrote)
and takes the mean over steps of NT-Xent between the views. A stage-3 step
runs the T steps one aggregator call of 2B bags each (view 0's bags first),
each with its own seed; from t=1 each view's actions come from the fixed
policy acting on that view's previous embedding with its own recurrent
state, ``clamp(mean + std * noise, 0, 1)``.

The aggregator runs in blocks of bags that hold whole mixing groups: a
forward of every block without gradients gives the embeddings, the head and
loss give their gradient, then each block is run again with gradients and
back-propagated from its share. So the reference fits beside the bank at the
timed sizes.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from portbench.reference.model import Reference, adam_step, mix, sub_bags


class Bank(SimpleNamespace):
    """The benchmark's feature bank: ``feats (P, D)``, ``offsets``,
    ``num_patches``, ``cluster_sizes``, ``patch_cluster``, ``patch_pos``."""


def _bags(bank: Bank, ids, actions, feat_size: int):
    return sub_bags(bank.feats, bank.offsets, bank.num_patches, bank.patch_cluster,
                    bank.patch_pos, bank.cluster_sizes, ids, actions, feat_size)


def _leaves(p: Dict[str, torch.Tensor]):
    return {k: v.detach().clone().requires_grad_() for k, v in p.items()}


def _head_losses(ref: Reference, hp, emb, b: int, temperature: float):
    """Per-step NT-Xent over the GRU head's projections. ``emb (T, 2B, F)``,
    view 0's bags first in each step."""
    losses, carry = [], None
    for t in range(emb.shape[0]):
        ea, eb = emb[t, :b], emb[t, b:]
        if t == 0:
            pa, _ = ref.head(hp, ea)
            pb, carry = ref.head(hp, eb)
        else:
            pa, mid = ref.head(hp, ea, carry)
            pb, carry = ref.head(hp, eb, mid)
        losses.append(ref.nt_xent(pa, pb, temperature))
    return torch.stack(losses)


class StepResult(SimpleNamespace):
    """``loss`` (the step's mean NT-Xent), ``step_losses (T,)``, ``grads`` (by
    leaf, as the optimizer takes them), ``means`` (stage 3: the policy's own
    means, ``(T-1, 2, B, K)``)."""


def train_step(ref: Reference, params: Dict[str, torch.Tensor], bank: Bank, draws,
               traffic: dict, policy: Optional[Dict[str, torch.Tensor]] = None,
               followed_means: Optional[torch.Tensor] = None) -> StepResult:
    """Loss and gradients of one step at ``params`` (model and head leaves,
    by name), without the optimizer. ``draws``: ``ids (B,)``, the actions,
    mixing factors and permutations and the dropout ``seeds``; stage 3 takes
    its actions from ``followed_means`` (the means of the run under test,
    ``(T-1, 2, B, K)``), or from its own where None, and reports its own."""
    t_steps, feat, b = traffic["T"], traffic["feat_size"], len(draws.ids)
    stage = traffic["stage"]
    dev = bank.feats.device
    agg = {k: v for k, v in params.items() if k.startswith("encoder.")}
    hp = {k: v for k, v in params.items() if not k.startswith("encoder.")}
    means = None

    if stage == 1:
        acts = draws.actions.to(dev).reshape(t_steps * 2, b, -1)
        ids2 = torch.cat([draws.ids, draws.ids]).to(dev)
        groups = []
        for g in range(t_steps * 2):
            view = g % 2
            groups.append(dict(ids=ids2[view * b:(view + 1) * b], acts=acts[g],
                               perm=draws.perms[g].to(dev), lam=draws.lams[g].to(dev),
                               seed=draws.seeds[0] if draws.seeds else 0, bag0=g * b))
        blocks = groups  # one (step, view) group a block
    elif stage == 3:
        std = ref.cfg["action_std"]
        blocks, states, means, embs = [], None, [], []
        pol_h = [None, None]
        with torch.no_grad():
            for t in range(t_steps):
                if t == 0:
                    a = draws.actions0.to(dev)
                else:
                    step_means = []
                    for v in (0, 1):
                        if pol_h[v] is None:
                            pol_h[v] = states.new_zeros((b, ref.cfg["policy_hidden_dim"]))
                        mean, pol_h[v] = ref.policy_mean(policy, states[v], pol_h[v])
                        step_means.append(mean)
                    means.append(torch.stack(step_means))
                    follow = (means[-1] if followed_means is None
                              else followed_means[t - 1].to(dev))
                    a = (follow + draws.noise[t - 1].to(dev) * std).clamp(0.0, 1.0)
                blk = dict(ids=torch.cat([draws.ids, draws.ids]).to(dev),
                           acts=torch.cat([a[0], a[1]]), seed=draws.seeds[t] if draws.seeds else 0, bag0=0,
                           perm=torch.cat([draws.perms[t, 0], draws.perms[t, 1] + b]).to(dev),
                           lam=torch.cat([draws.lams[t, 0], draws.lams[t, 1]]).to(dev))
                blocks.append(blk)
                x = mix(_bags(bank, blk["ids"], blk["acts"], feat), blk["perm"], blk["lam"])
                embs.append(ref.aggregate(agg, x, blk["seed"], 0))
                states = embs[-1].reshape(2, b, -1)
        means = torch.stack(means)
    else:
        raise ValueError(f"no reference for stage {stage}")

    if stage == 1:
        with torch.no_grad():
            embs = [ref.aggregate(agg, mix(_bags(bank, k["ids"], k["acts"], feat), k["perm"],
                                           k["lam"]), k["seed"], k["bag0"]) for k in blocks]
    emb = torch.cat(embs)
    emb = emb.reshape(t_steps, 2 * b, -1).requires_grad_()
    hl = _leaves(hp)
    step_losses = _head_losses(ref, hl, emb, b, traffic["temperature"])
    total = step_losses.sum() / t_steps
    d_emb, *d_head = torch.autograd.grad(total, [emb, *hl.values()])
    grads = dict(zip(hl.keys(), d_head))
    d_emb = d_emb.reshape(len(blocks), -1, d_emb.shape[-1])

    al = _leaves(agg)
    for k, blk in enumerate(blocks):
        with torch.no_grad():
            x = mix(_bags(bank, blk["ids"], blk["acts"], feat), blk["perm"], blk["lam"])
        out = ref.aggregate(al, x, blk["seed"], blk["bag0"])
        torch.autograd.backward(out, d_emb[k])
    grads.update({k: v.grad for k, v in al.items() if v.grad is not None})
    return StepResult(loss=total.detach(), step_losses=step_losses.detach(), grads=grads,
                      means=means)


def run_steps(ref: Reference, weights: Dict[str, Dict[str, torch.Tensor]], bank: Bank,
              steps: List, traffic: dict, cfg: dict,
              followed_means: Optional[List[torch.Tensor]] = None) -> SimpleNamespace:
    """The reference over the checked steps from the benchmark's weights
    (``weights["model"]``, ``["fc"]``, stage 3 ``["policy"]``): ``losses``
    (one per step), ``grad1`` (the first step's gradients, decay included),
    ``loss_grad1`` (those of the loss alone, the leaves it reaches),
    ``params`` (after the last step), ``means`` (stage 3: its own policy
    means per step)."""
    params = {k: v.detach().clone() for g in ("model", "fc") for k, v in weights[g].items()}
    lrs = {k: traffic["backbone_lr"] if k.startswith("encoder.") else traffic["fc_lr"]
           for k in params}
    state: dict = {}
    losses, grad1, loss_grad1, means = [], None, None, []
    for i, draws in enumerate(steps):
        res = train_step(ref, params, bank, draws, traffic, weights.get("policy"),
                         None if followed_means is None else followed_means[i])
        with torch.no_grad():
            g = adam_step(params, res.grads, state, lrs, i + 1, cfg["beta1"], cfg["beta2"],
                          cfg["wdecay"])
        if grad1 is None:
            grad1, loss_grad1 = g, res.grads
        losses.append(float(res.loss))
        means.append(res.means)
    return SimpleNamespace(losses=losses, grad1=grad1, loss_grad1=loss_grad1, params=params,
                           means=means)
