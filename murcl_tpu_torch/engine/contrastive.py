"""MuRCL contrastive pretraining engine, stages 1, 2 and 3, for CLAM_SB and ABMIL.

Counterpart of ``murcl_tpu/engine/contrastive.py`` ``ContrastiveEngine``.
Per batch, two views of sub-bags are selected, mixed, encoded by the shared
aggregator and projected by the shared GRU head; each step's loss is NT-Xent
between the views, and the reward ``sim_{t-1} - sim_t`` (decreasing cosine
similarity is rewarded).

- Stage 1 (:meth:`ContrastiveEngine.rollout_batched`, JAX
  ``_rollout_batched`` ``:185-300``) draws every action uniformly at
  random, so all T steps x 2 views select, compact (K1), mix and encode as
  one ``(T*2B, feat_size, D)`` batch; only the GRU head and the per-step
  NT-Xent run step by step. CLAM_SB folds the mix into its fused trunk
  kernel (K2/K3); ABMIL mixes with :func:`~murcl_tpu_torch.ops.mixup.mixup_rows`
  (K6) first, as the JAX engine does for an arch off CLAM's fused route.
- Stages 2 and 3 (:meth:`ContrastiveEngine.rollout_sequential`, JAX
  ``_rollout_sequential`` ``:302-430``) run T steps of one aggregator
  forward over both views (2B bags). t=0 takes two uniform action draws;
  from t=1 each view's actions come from ``policy_old`` acting on that
  view's previous embedding, each view with its own policy carry starting at
  zero. CLAM_SB folds the mix into K2; ABMIL mixes each view with
  :func:`~murcl_tpu_torch.ops.mixup.mixup_ref`, the JAX ``mixup`` expression.
- Stage 2 runs the rollout with the aggregator and head in eval mode and no
  gradient, then one PPO update per view, view 0 first; stages 1 and 3
  back-propagate the mean of the T losses and step the optimizer (the
  policy stays fixed in stage 3).

The reference ``Full_layer`` keeps its GRU hidden as module state and the
two views call it in turn, so the hidden state interleaves across views:
at t=0 each view restarts from zeros and view 1's carry is kept; at each
later step view 0 consumes the carry view 1 wrote. One carry threads view0
-> view1 per step to match.

Data parallelism (``dp``, a :class:`~murcl_tpu_torch.parallel.Ranks`; the
JAX engine's ``mesh=``): each rank runs the rollout on its own rows of the
global batch, with its own generator, so its actions, mixup draws (pairs
within the rank's rows, as within a JAX shard) and dropout seeds are its
own. NT-Xent runs over the gathered ``(B_global, C)`` projections of both
views, the same loss on every rank, whose backward reaches only the rank's
own rows; the rewards are global means; :func:`~murcl_tpu_torch.engine.optim.step`
sums the gradients over the ranks before the replicated update; and in
stage 2 each view's rollout is gathered in rank order before the PPO
update, which every rank runs on the same numbers.

Random draws come from one explicit CPU ``torch.Generator`` in a fixed
order. Stage 1: the actions ``(T, 2, B, K)``, the mixup draws of each
(step, view) group, then one dropout seed per aggregator forward. Stages 2
and 3: the t=0 actions ``(2, B, K)``; then per step, for t >= 1 the policy
noise of view 0 and of view 1, and for every step the mixup draws of view 0
and of view 1 and the forward's dropout seed. Tests inject the actions, the
noise and the mixup draws.

Under a profiler each step opens the spans of
:mod:`murcl_tpu_torch.utils.trace`: the draws and their moves to the card
share one ``murcl.draws`` span a rollout step, ahead of the selection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from murcl_tpu_torch.engine import optim
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.losses import cosine_similarity
from murcl_tpu_torch.models.rlmil import Rollout, act
from murcl_tpu_torch.ops.mixup import mixup_factors, mixup_ref, mixup_rows
from murcl_tpu_torch.ops.ntxent import nt_xent
from murcl_tpu_torch.ops.select import select_feats
from murcl_tpu_torch.parallel import SINGLE, Ranks
from murcl_tpu_torch.utils.trace import span, step

ARCHS = ("ABMIL", "CLAM_SB")


class PretrainStats(NamedTuple):
    loss: torch.Tensor  # scalar: mean of the T NT-Xent losses
    step_losses: torch.Tensor  # (T,)
    rewards: torch.Tensor  # (T-1,) batch-mean reward per step


class ContrastiveEngine:
    """One MuRCL training step over a device-resident feature bank.

    ``model`` is the ``CL``-wrapped aggregator, ``fc`` the GRU head, ``ppo``
    a :class:`~murcl_tpu_torch.models.rlmil.PPO` (stages 2 and 3) and
    ``optimizer`` over model and fc (stages 1 and 3), ``dp`` this process's
    data-parallel rank (a single process by default).
    """

    def __init__(self, cfg: PretrainConfig, model, fc, optimizer=None, ppo=None,
                 dp: Ranks = SINGLE):
        if cfg.arch not in ARCHS:
            raise NotImplementedError(
                f"{cfg.arch} has no MuRCL pretraining: the JAX package's MuRCL CLI offers "
                "ABMIL and CLAM_SB only (train_MuRCL.py:13; ROADMAP, the MuRCL archs)")
        if cfg.uses_policy and ppo is None:
            raise ValueError(f"stage {cfg.train_stage} requires a PPO policy")
        if cfg.train_stage != 2 and optimizer is None:
            raise ValueError("stages 1/3 require an optimizer")
        self.cfg = cfg
        self.model = model
        self.fc = fc
        self.optimizer = optimizer
        self.ppo = ppo
        self.dp = dp
        self.cdtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        # CLAM_SB's fused trunk kernel mixes in place of a standalone pass
        self.fused_mix = cfg.arch == "CLAM_SB"

    def _encode(self, x, generator, mix=None):
        """Aggregator forward of the bags ``x``: the f32 embedding ``(B, F)``."""
        kwargs = {"mix": mix} if mix is not None else {}
        with span("murcl.aggregator"):
            emb, _ = self.model.encoder(x.to(self.cdtype), generator=generator, **kwargs)
            return emb.float()

    def _nt_xent(self, a, b):
        """NT-Xent over the global batch: both views' projections gathered."""
        return nt_xent(self.dp.gather(a), self.dp.gather(b), self.cfg.temperature)

    def rollout_batched(self, bank, slide_ids, generator: torch.Generator,
                        actions: Optional[torch.Tensor] = None, mix=None):
        """Loss of one stage-1 rollout: ``(total, PretrainStats)``.

        ``actions (T, 2, B, K)`` and ``mix=(lams (T*2, B), perms (T*2, B))``
        override the random draws (parity tests).
        """
        cfg = self.cfg
        b, t_steps = slide_ids.shape[0], cfg.T
        dev = bank.feats.device
        with span("murcl.draws"):
            if actions is None:
                actions = torch.rand((t_steps, 2, b, cfg.num_clusters), generator=generator,
                                     device=generator.device)
            if mix is None:
                draws = [mixup_factors(generator, b, cfg.alpha) for _ in range(t_steps * 2)]
                mix = (torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]))
            lams, perms = mix
            actions = actions.to(dev).reshape(t_steps * 2 * b, cfg.num_clusters)
            # mixup permutes within each (step, view) group of b bags
            base = torch.arange(t_steps * 2)[:, None] * b
            perm_abs = (perms.to(torch.int64).cpu() + base).reshape(-1).to(dev)
            lam_flat = lams.reshape(-1).to(dev)

        both_ids = torch.cat([slide_ids, slide_ids]).repeat(t_steps)
        x_flat = select_feats(bank, both_ids, actions, cfg.feat_size)
        if self.fused_mix:
            emb = self._encode(x_flat, generator, mix=(perm_abs, lam_flat))
        else:
            with span("murcl.mixup"):
                x_flat = mixup_rows(x_flat, perm_abs, lam_flat)
            emb = self._encode(x_flat, generator)
        emb = emb.reshape(t_steps, 2, b, -1)

        proj_a, _ = self.fc(emb[0, 0])
        proj_b, carry = self.fc(emb[0, 1])
        projs = [(proj_a, proj_b)]
        for t in range(1, t_steps):
            pa, c_mid = self.fc(emb[t, 0], carry)
            pb, carry = self.fc(emb[t, 1], c_mid)
            projs.append((pa, pb))
        with span("murcl.loss"):
            step_losses = torch.stack([self._nt_xent(pa, pb) for pa, pb in projs])
            total = step_losses.sum() / t_steps
            with torch.no_grad():  # rewards are reported only in stage 1
                sims = torch.stack([cosine_similarity(pa, pb) for pa, pb in projs])
                rewards = self.dp.mean((sims[:-1] - sims[1:]).mean(dim=1))
        return total, PretrainStats(total.detach(), step_losses.detach(), rewards)

    def _pair_forward(self, bank, slide_ids, actions, carry, generator, mix_t):
        """Both views of one step through one aggregator forward of 2B bags
        (K1 compacts both from the same slide windows), then the GRU head,
        view 0 then view 1: ``(proj (2, B, C), states (2, B, F), carry)``.
        ``carry=None`` restarts each view's head from zeros (t=0)."""
        cfg = self.cfg
        b = slide_ids.shape[0]
        dev = bank.feats.device
        with span("murcl.draws"):
            actions = torch.cat([actions[0], actions[1]]).to(dev)
            if mix_t is None:
                mix_t = [mixup_factors(generator, b, cfg.alpha) for _ in range(2)]
            (lam_a, perm_a), (lam_b, perm_b) = [(lam.to(dev), perm.to(dev, torch.int64))
                                                for lam, perm in mix_t]
        x2 = select_feats(bank, torch.cat([slide_ids, slide_ids]), actions, cfg.feat_size)
        if self.fused_mix:
            emb2 = self._encode(x2, generator, mix=(torch.cat([perm_a, perm_b + b]),
                                                    torch.cat([lam_a, lam_b])))
        else:
            with span("murcl.mixup"):
                x2 = torch.cat([mixup_ref(x2[:b], perm_a, lam_a),
                                mixup_ref(x2[b:], perm_b, lam_b)])
            emb2 = self._encode(x2, generator)
        if carry is None:
            proj_a, _ = self.fc(emb2[:b])
            proj_b, carry = self.fc(emb2[b:])
        else:
            proj_a, c_mid = self.fc(emb2[:b], carry)
            proj_b, carry = self.fc(emb2[b:], c_mid)
        states = emb2.detach().reshape(2, b, -1)
        return torch.stack([proj_a, proj_b]), states, carry

    def rollout_sequential(self, bank, slide_ids, generator: torch.Generator,
                           actions0: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None, mix=None):
        """Stages 2/3 rollout (needs the policy): ``(total, PretrainStats,
        (Rollout of view 0, Rollout of view 1))``. ``actions0 (2, B, K)``, the
        standard-normal policy ``noise (T-1, 2, B, K)`` and ``mix=(lams (T, 2,
        B), perms (T, 2, B))`` override the random draws (tests)."""
        cfg = self.cfg
        b = slide_ids.shape[0]
        dev = bank.feats.device
        mix_of = lambda t: None if mix is None else [(mix[0][t, v], mix[1][t, v])  # noqa: E731
                                                     for v in (0, 1)]
        if actions0 is None:
            with span("murcl.draws"):
                actions0 = torch.rand((2, b, cfg.num_clusters), generator=generator,
                                      device=generator.device)
        projs, states, fc_carry = self._pair_forward(bank, slide_ids, actions0, None,
                                                     generator, mix_of(0))
        with span("murcl.loss"):
            losses = [self._nt_xent(projs[0], projs[1])]
            sim_last = cosine_similarity(projs[0].detach(), projs[1].detach())

        pol = [self.ppo.zero_hidden(b, dev), self.ppo.zero_hidden(b, dev)]
        steps, rewards = ([], []), []
        for t in range(1, cfg.T):
            acts = []
            for v in (0, 1):
                action, pol[v], pstep = act(self.ppo.policy_old, states[v], pol[v], generator,
                                            None if noise is None else noise[t - 1, v])
                acts.append(action)
                steps[v].append(pstep)
            projs, states, fc_carry = self._pair_forward(bank, slide_ids, acts, fc_carry,
                                                         generator, mix_of(t))
            with span("murcl.loss"):
                losses.append(self._nt_xent(projs[0], projs[1]))
                sim = cosine_similarity(projs[0].detach(), projs[1].detach())
                rewards.append(sim_last - sim)
                sim_last = sim

        with span("murcl.loss"):
            step_losses = torch.stack(losses)
            total = step_losses.sum() / cfg.T
            rewards = torch.stack(rewards)
        rollouts = tuple(
            Rollout(states=torch.stack([s.state for s in view]),
                    actions=torch.stack([s.action for s in view]),
                    logprobs=torch.stack([s.logprob for s in view]), rewards=rewards)
            for view in steps)
        stats = PretrainStats(total.detach(), step_losses.detach(),
                              self.dp.mean(rewards.mean(dim=1)))
        return total, stats, rollouts

    def train_step(self, bank, slide_ids, generator: torch.Generator, **draws) -> PretrainStats:
        """One optimizer step (stages 1/3) or one PPO update per view (stage
        2). ``draws`` go to the rollout (tests inject the random draws)."""
        cfg = self.cfg
        with step(bank.feats.device):
            if cfg.train_stage == 2:
                self.model.eval()
                self.fc.eval()
                with torch.no_grad():
                    _, stats, rollouts = self.rollout_sequential(bank, slide_ids, generator,
                                                                 **draws)
                for rollout in rollouts:  # view 0 first (train_MuRCL.py:296-298)
                    self.ppo.update(Rollout(*(self.dp.gather(x, dim=1) for x in rollout)))
                return stats
            self.model.train()
            self.fc.train()
            self.optimizer.zero_grad(set_to_none=True)
            if cfg.uses_policy:
                total, stats, _ = self.rollout_sequential(bank, slide_ids, generator, **draws)
            else:
                total, stats = self.rollout_batched(bank, slide_ids, generator, **draws)
            total.backward()
            optim.step(self.optimizer, self.dp)
            return stats
