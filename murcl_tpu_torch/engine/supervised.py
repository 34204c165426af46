"""Supervised RLMIL engine for CLAM_SB (counterpart of ``murcl_tpu/engine/supervised.py``).

Per batch, a T-step rollout over sub-bags selected from each slide's cluster
windows, with the GRU head ``fc`` accumulating across steps. The step loss
is ``bag_weight * CE + (1 - bag_weight) * masked_mean(instance_loss)`` and
the reward is the change of the true class's confidence between steps.

- Stage 1 draws every action uniformly at random, so :meth:`rollout_batched`
  selects, compacts and encodes all ``T * B`` sub-bags in one batch (K1
  compaction, then the CLAM trunk and K7); only the GRU head runs step by
  step.
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
batch. Random draws come from one CPU ``torch.Generator``: actions, then a
dropout seed per aggregator forward, then the policy noise of each step.
Tests inject the actions and the noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from murcl_tpu_torch.engine import optim
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.losses import cross_entropy, label_confidence, masked_mean
from murcl_tpu_torch.models.rlmil import Rollout, act
from murcl_tpu_torch.ops.select import select_feats


class StepStats(NamedTuple):
    loss: torch.Tensor  # scalar: mean of the T step losses
    step_losses: torch.Tensor  # (T,)
    rewards: torch.Tensor  # (T-1,) batch-mean reward per step
    logits: torch.Tensor  # (B, C) final-step outputs (metrics source)


class SupervisedEngine:
    """Train and eval steps of one stage. ``model`` is the bare CLAM_SB,
    ``fc`` the GRU head, ``ppo`` a :class:`~murcl_tpu_torch.models.rlmil.PPO`
    (stages 2 and 3), ``optimizer`` over model and fc (stages 1 and 3)."""

    def __init__(self, cfg: RolloutConfig, model, fc, ppo=None, optimizer=None):
        if cfg.arch != "CLAM_SB":
            raise NotImplementedError(
                f"{cfg.arch} in the supervised engine is not ported yet: ROADMAP queue 1, "
                "item 12")
        if cfg.uses_policy and ppo is None:
            raise ValueError(f"stage {cfg.train_stage} requires a PPO policy")
        if cfg.train_stage != 2 and optimizer is None:
            raise ValueError("stages 1/3 require an optimizer")
        self.cfg = cfg
        self.model = model
        self.fc = fc
        self.ppo = ppo
        self.optimizer = optimizer
        self.cdtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def _encode(self, feats, labels, generator):
        """``(fc_in (B, F) f32, extra (B,))``: the pooled embedding and the
        weighted instance loss of each bag."""
        m, aux = self.model(feats.to(self.cdtype), instance_eval=True, label=labels,
                            generator=generator)
        return m.float(), (1.0 - self.cfg.bag_weight) * aux["instance_loss"].float()

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
        extra_step = torch.stack([masked_mean(e, valid) for e in extra_flat.reshape(t_steps, b)])

        logits, carry = [], None
        for t in range(t_steps):
            lg, carry = self.fc(fc_in[t], carry)
            logits.append(lg)
        logits_all = torch.stack(logits)  # (T, B, C)
        step_ce = torch.stack([cross_entropy(lg, labels, valid) for lg in logits])
        step_losses = cfg.bag_weight * step_ce + extra_step
        total = step_losses.sum() / t_steps

        conf = label_confidence(logits_all.detach(), labels)  # (T, B)
        rewards = conf[1:] - conf[:-1]
        rollout = Rollout(states=fc_in.detach()[:-1], actions=actions[1:],
                          logprobs=torch.zeros((t_steps - 1, b), device=dev), rewards=rewards)
        stats = StepStats(total.detach(), step_losses.detach(), rewards.mean(dim=1),
                          logits_all[-1].detach())
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
            loss = cfg.bag_weight * cross_entropy(logits, labels, valid) + \
                masked_mean(extra, valid)
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
        stats = StepStats(total.detach(), step_losses.detach(), rewards.mean(dim=1),
                          logits.detach())
        return total, stats, rollout

    def _rollout(self, bank, slide_ids, labels, valid, generator):
        if self.cfg.uses_policy:
            return self.rollout_sequential(bank, slide_ids, labels, valid, generator)
        return self.rollout_batched(bank, slide_ids, labels, valid, generator)

    def _modes(self, train: bool) -> None:
        self.model.train(train)
        self.fc.train(train)

    def train_step(self, bank, slide_ids, generator: torch.Generator,
                   valid: Optional[torch.Tensor] = None) -> StepStats:
        """One optimizer step (stages 1/3) or one PPO update (stage 2)."""
        labels = bank.labels[slide_ids]
        if valid is None:
            valid = torch.ones(slide_ids.shape, dtype=torch.bool, device=slide_ids.device)
        if self.cfg.train_stage == 2:
            self._modes(False)
            with torch.no_grad():
                _, stats, rollout = self._rollout(bank, slide_ids, labels, valid, generator)
            self.ppo.update(rollout)
            return stats
        self._modes(True)
        self.optimizer.zero_grad(set_to_none=True)
        total, stats, _ = self._rollout(bank, slide_ids, labels, valid, generator)
        total.backward()
        optim.step(self.optimizer)
        return stats

    @torch.no_grad()
    def eval_step(self, bank, slide_ids, generator: torch.Generator,
                  valid: Optional[torch.Tensor] = None) -> StepStats:
        """T-step rollout in eval mode (sampled actions, reference quirk)."""
        labels = bank.labels[slide_ids]
        if valid is None:
            valid = torch.ones(slide_ids.shape, dtype=torch.bool, device=slide_ids.device)
        self._modes(False)
        return self._rollout(bank, slide_ids, labels, valid, generator)[1]
