"""Supervised RLMIL engine for ABMIL, CLAM_SB and DSMIL (counterpart of
``murcl_tpu/engine/supervised.py``).

Per batch, a T-step rollout over sub-bags selected from each slide's cluster
windows, with the GRU head ``fc`` accumulating across steps. The step loss
is ``w * CE(fc logits)`` plus the arch's extra term, and the reward is the
change of the true class's confidence between steps:

- ABMIL: ``w = 1``, no extra; its t=0 forward trains, as every command
  line of the reference gets (``--train_model_prime`` is ``store_true``
  with default ``True``, so no command line turns it off);
- CLAM_SB: ``w = bag_weight``, extra ``(1 - bag_weight) *
  masked_mean(instance_loss)``;
- DSMIL: ``w = 0.5``, extra ``0.5 * CE`` of the max over N of the instance
  logits; ``fc``'s input is the mean over classes of the bag tensor.

- Stage 1 draws every action uniformly at random, so :meth:`rollout_batched`
  selects, compacts and encodes all ``T * B`` sub-bags in one batch (K1
  compaction, then the aggregator: CLAM's trunk and K7, ABMIL's encoder and
  K7, or DSMIL's plain products); only the GRU head runs step by step.
- Stages 2 and 3 (and their evaluation) run :meth:`rollout_sequential`: t=0
  takes uniform actions and a fresh GRU; from t=1 the actions come from
  ``policy_old`` acting on the previous step's ``fc`` input (no gradient),
  its hidden state starting at zero. Each step selects its own B sub-bags:
  one compaction per step, the JAX package's K5.
- Stage 2 runs the rollout with the aggregator in eval mode and no
  gradient, then one PPO update; stages 1 and 3 back-propagate the mean of
  the T step losses and take one optimizer step.
- Evaluation runs ``train=False`` rollouts with *sampled* actions, the
  reference's quirk (``murcl_tpu/engine/supervised.py:17-19``).

A ``valid`` mask (B,) runs through every batch mean, for the padded last
batch.

Data parallelism (``dp``, a :class:`~murcl_tpu_torch.parallel.Ranks`; the
JAX engine's ``mesh=``): each rank steps on its own rows of the global batch
with its own generator. The CE and the arch's extra are global masked means
(numerator and count summed over the ranks), the rewards global means, the
final-step logits come back gathered in global order (the metrics' input),
:func:`~murcl_tpu_torch.engine.optim.step` sums the gradients over the ranks
before the replicated update, and stage 2 gathers the rollout before the PPO
update, which every rank runs on the same numbers.

Random draws come from one CPU ``torch.Generator``: actions, then a dropout
seed per aggregator forward, then the policy noise of each step. Tests
inject the actions and the noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from murcl_tpu_torch.engine import optim
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.losses import cross_entropy, label_confidence, masked_mean
from murcl_tpu_torch.models.rlmil import Rollout, act
from murcl_tpu_torch.ops.select import select_feats
from murcl_tpu_torch.parallel import SINGLE, Ranks


class StepStats(NamedTuple):
    loss: torch.Tensor  # scalar: mean of the T step losses
    step_losses: torch.Tensor  # (T,)
    rewards: torch.Tensor  # (T-1,) batch-mean reward per step
    logits: torch.Tensor  # (B, C) final-step outputs of the global batch (metrics source)


class SupervisedEngine:
    """Train and eval steps of one stage. ``model`` is the bare aggregator
    (``cfg.arch``), ``fc`` the GRU head, ``ppo`` a
    :class:`~murcl_tpu_torch.models.rlmil.PPO` (stages 2 and 3),
    ``optimizer`` over model and fc (stages 1 and 3), ``dp`` this process's
    data-parallel rank (a single process by default)."""

    def __init__(self, cfg: RolloutConfig, model, fc, ppo=None, optimizer=None,
                 dp: Ranks = SINGLE):
        # the weight of the fc head's CE in each arch's step loss
        ce_weight = {"ABMIL": 1.0, "CLAM_SB": cfg.bag_weight, "DSMIL": 0.5}
        if cfg.arch not in ce_weight:
            raise ValueError(f"unknown arch {cfg.arch!r}; expected ABMIL | CLAM_SB | DSMIL")
        if cfg.uses_policy and ppo is None:
            raise ValueError(f"stage {cfg.train_stage} requires a PPO policy")
        if cfg.train_stage != 2 and optimizer is None:
            raise ValueError("stages 1/3 require an optimizer")
        self.cfg = cfg
        self.model = model
        self.fc = fc
        self.ppo = ppo
        self.optimizer = optimizer
        self.dp = dp
        self.cdtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.ce_weight = ce_weight[cfg.arch]

    def _encode(self, feats, labels, generator):
        """``(fc_in (B, F) f32, extra (B,))``: the bag embedding and the
        weighted extra loss of each bag."""
        x = feats.to(self.cdtype)
        if self.cfg.arch == "ABMIL":
            out, _ = self.model(x, generator=generator)
            return out.float(), torch.zeros(x.shape[0], device=x.device)
        if self.cfg.arch == "CLAM_SB":
            m, aux = self.model(x, instance_eval=True, label=labels, generator=generator)
            return m.float(), (1.0 - self.cfg.bag_weight) * aux["instance_loss"].float()
        inst, bag, _ = self.model(x, generator=generator)
        logp = torch.log_softmax(inst.amax(dim=1).float(), dim=-1)
        return bag.mean(dim=1).float(), -0.5 * logp.gather(1, labels[:, None])[:, 0]

    def rollout_batched(self, bank, slide_ids, labels, valid, generator: torch.Generator,
                        actions: Optional[torch.Tensor] = None):
        """Stage-1 rollout: ``(total, StepStats, Rollout)``; ``actions (T, B,
        K)`` overrides the random draw (tests)."""
        cfg = self.cfg
        b, t_steps = slide_ids.shape[0], cfg.T
        dev = bank.feats.device
        if actions is None:
            actions = torch.rand((t_steps, b, cfg.num_clusters), generator=generator,
                                 device=generator.device)
        actions = actions.to(dev)
        x = select_feats(bank, slide_ids.repeat(t_steps),
                         actions.reshape(t_steps * b, cfg.num_clusters), cfg.feat_size)
        fc_in_flat, extra_flat = self._encode(x, labels.repeat(t_steps), generator)
        fc_in = fc_in_flat.reshape(t_steps, b, -1)
        extra_step = torch.stack([masked_mean(e, valid, self.dp)
                                  for e in extra_flat.reshape(t_steps, b)])

        logits, carry = [], None
        for t in range(t_steps):
            lg, carry = self.fc(fc_in[t], carry)
            logits.append(lg)
        logits_all = torch.stack(logits)  # (T, B, C)
        step_ce = torch.stack([cross_entropy(lg, labels, valid, self.dp) for lg in logits])
        step_losses = self.ce_weight * step_ce + extra_step
        total = step_losses.sum() / t_steps

        conf = label_confidence(logits_all.detach(), labels)  # (T, B)
        rewards = conf[1:] - conf[:-1]
        rollout = Rollout(states=fc_in.detach()[:-1], actions=actions[1:],
                          logprobs=torch.zeros((t_steps - 1, b), device=dev), rewards=rewards)
        stats = StepStats(total.detach(), step_losses.detach(),
                          self.dp.mean(rewards.mean(dim=1)),
                          self.dp.gather(logits_all[-1].detach()))
        return total, stats, rollout

    def rollout_sequential(self, bank, slide_ids, labels, valid, generator: torch.Generator,
                           actions0: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None):
        """Stages 2/3 rollout (needs the policy): ``(total, StepStats,
        Rollout)``. ``actions0 (B, K)`` and the standard-normal policy
        ``noise (T-1, B, K)`` override the random draws (tests)."""
        cfg = self.cfg
        b = slide_ids.shape[0]
        dev = bank.feats.device

        def forward(actions, carry):
            x = select_feats(bank, slide_ids, actions.to(dev), cfg.feat_size)
            fc_in, extra = self._encode(x, labels, generator)
            logits, carry = self.fc(fc_in, carry)
            loss = self.ce_weight * cross_entropy(logits, labels, valid, self.dp) + \
                masked_mean(extra, valid, self.dp)
            return logits, carry, fc_in.detach(), loss

        if actions0 is None:
            actions0 = torch.rand((b, cfg.num_clusters), generator=generator,
                                  device=generator.device)
        logits, fc_carry, state, loss = forward(actions0, None)
        conf_last = label_confidence(logits.detach(), labels)
        pol_hidden = self.ppo.zero_hidden(b, dev)

        losses, steps, rewards = [loss], [], []
        for t in range(1, cfg.T):
            action, pol_hidden, pstep = act(self.ppo.policy_old, state, pol_hidden, generator,
                                            None if noise is None else noise[t - 1])
            logits, fc_carry, state, loss = forward(action, fc_carry)
            conf = label_confidence(logits.detach(), labels)
            rewards.append(conf - conf_last)
            conf_last = conf
            losses.append(loss)
            steps.append(pstep)

        step_losses = torch.stack(losses)
        total = step_losses.sum() / cfg.T
        rewards = torch.stack(rewards)
        rollout = Rollout(states=torch.stack([s.state for s in steps]),
                          actions=torch.stack([s.action for s in steps]),
                          logprobs=torch.stack([s.logprob for s in steps]), rewards=rewards)
        stats = StepStats(total.detach(), step_losses.detach(),
                          self.dp.mean(rewards.mean(dim=1)), self.dp.gather(logits.detach()))
        return total, stats, rollout

    def _rollout(self, bank, slide_ids, labels, valid, generator, **draws):
        if self.cfg.uses_policy:
            return self.rollout_sequential(bank, slide_ids, labels, valid, generator, **draws)
        return self.rollout_batched(bank, slide_ids, labels, valid, generator, **draws)

    def _modes(self, train: bool) -> None:
        self.model.train(train)
        self.fc.train(train)

    def train_step(self, bank, slide_ids, generator: torch.Generator,
                   valid: Optional[torch.Tensor] = None, **draws) -> StepStats:
        """One optimizer step (stages 1/3) or one PPO update (stage 2).
        ``draws`` go to the rollout (tests inject the random draws)."""
        labels = bank.labels[slide_ids]
        if valid is None:
            valid = torch.ones(slide_ids.shape, dtype=torch.bool, device=slide_ids.device)
        if self.cfg.train_stage == 2:
            self._modes(False)
            with torch.no_grad():
                _, stats, rollout = self._rollout(bank, slide_ids, labels, valid, generator,
                                                  **draws)
            self.ppo.update(Rollout(*(self.dp.gather(x, dim=1) for x in rollout)))
            return stats
        self._modes(True)
        self.optimizer.zero_grad(set_to_none=True)
        total, stats, _ = self._rollout(bank, slide_ids, labels, valid, generator, **draws)
        total.backward()
        optim.step(self.optimizer, self.dp)
        return stats

    @torch.no_grad()
    def eval_step(self, bank, slide_ids, generator: torch.Generator,
                  valid: Optional[torch.Tensor] = None, **draws) -> StepStats:
        """T-step rollout in eval mode (sampled actions, reference quirk) of
        this rank's rows; the logits come back for every rank's rows."""
        labels = bank.labels[slide_ids]
        if valid is None:
            valid = torch.ones(slide_ids.shape, dtype=torch.bool, device=slide_ids.device)
        self._modes(False)
        return self._rollout(bank, slide_ids, labels, valid, generator, **draws)[1]
