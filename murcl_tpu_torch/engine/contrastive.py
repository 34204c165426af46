"""MuRCL stage-1 contrastive pretraining engine, batched layout.

Counterpart of ``murcl_tpu/engine/contrastive.py`` ``ContrastiveEngine``:
``_rollout_batched`` and the stage-1 branch of ``_train_impl``. Stage 1
draws every action uniformly at random, so all T steps x 2 views select,
compact, mix and encode as one ``(T*2B, feat_size, D)`` batch; only the GRU
head and the per-step NT-Xent run step by step.

The reference ``Full_layer`` keeps its GRU hidden as module state and the
two views call it in turn, so the hidden state interleaves across views:
at t=0 each view restarts from zeros and view 1's carry is kept; at each
later step view 0 consumes the carry view 1 wrote. The loop below threads
one carry view0 -> view1 per step to match.

Random draws come from one explicit CPU ``torch.Generator`` in a fixed
order: actions, the mixup draws of each (step, view) group, then one
dropout seed per aggregator forward. Tests inject actions and mixup draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.ops.mixup import mixup_factors
from murcl_tpu_torch.ops.ntxent import nt_xent
from murcl_tpu_torch.ops.select import select_feats


class PretrainStats(NamedTuple):
    loss: torch.Tensor  # scalar: mean of the T NT-Xent losses
    step_losses: torch.Tensor  # (T,)
    rewards: torch.Tensor  # (T-1,) batch-mean reward per step


class ContrastiveEngine:
    """Stage-1 MuRCL training step over a device-resident feature bank.

    ``model`` is the ``CL``-wrapped aggregator, ``fc`` the GRU head.
    """

    def __init__(self, cfg: PretrainConfig, model, fc, optimizer=None):
        if cfg.train_stage != 1:
            raise NotImplementedError(
                "stages 2/3 (PPO) are not ported yet (ROADMAP queue 1, slice 2)")
        if cfg.arch != "CLAM_SB":
            raise NotImplementedError(
                f"{cfg.arch} is not ported yet (ROADMAP queue 1, slice 3)")
        self.cfg = cfg
        self.model = model
        self.fc = fc
        self.optimizer = optimizer
        self.cdtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def rollout_batched(self, bank, slide_ids, generator: torch.Generator,
                        actions: Optional[torch.Tensor] = None, mix=None):
        """Loss of one stage-1 rollout: ``(total, PretrainStats)``.

        ``actions (T, 2, B, K)`` and ``mix=(lams (T*2, B), perms (T*2, B))``
        override the random draws (parity tests).
        """
        cfg = self.cfg
        b, t_steps = slide_ids.shape[0], cfg.T
        dev = bank.feats.device
        if actions is None:
            actions = torch.rand((t_steps, 2, b, cfg.num_clusters), generator=generator,
                                 device=generator.device)
        if mix is None:
            draws = [mixup_factors(generator, b, cfg.alpha) for _ in range(t_steps * 2)]
            mix = (torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]))
        lams, perms = mix

        both_ids = torch.cat([slide_ids, slide_ids]).repeat(t_steps)
        x_flat = select_feats(bank, both_ids,
                              actions.to(dev).reshape(t_steps * 2 * b, cfg.num_clusters),
                              cfg.feat_size)
        # mixup permutes within each (step, view) group of b bags
        base = torch.arange(t_steps * 2)[:, None] * b
        perm_abs = (perms.to(torch.int64).cpu() + base).reshape(-1).to(dev)
        emb, _ = self.model.encoder(x_flat.to(self.cdtype),
                                    mix=(perm_abs, lams.reshape(-1).to(dev)),
                                    generator=generator)
        emb = emb.float().reshape(t_steps, 2, b, -1)

        proj_a, _ = self.fc(emb[0, 0])
        proj_b, carry = self.fc(emb[0, 1])
        projs = [(proj_a, proj_b)]
        for t in range(1, t_steps):
            pa, c_mid = self.fc(emb[t, 0], carry)
            pb, carry = self.fc(emb[t, 1], c_mid)
            projs.append((pa, pb))
        step_losses = torch.stack([nt_xent(pa, pb, cfg.temperature) for pa, pb in projs])
        total = step_losses.sum() / t_steps

        with torch.no_grad():  # rewards are reported only in stage 1
            sims = torch.stack([F.cosine_similarity(pa, pb, dim=-1, eps=1e-8)
                                for pa, pb in projs])
            rewards = (sims[:-1] - sims[1:]).mean(dim=1)
        return total, PretrainStats(total.detach(), step_losses.detach(), rewards)

    def train_step(self, bank, slide_ids, generator: torch.Generator) -> PretrainStats:
        self.model.train()
        self.fc.train()
        self.optimizer.zero_grad(set_to_none=True)
        total, stats = self.rollout_batched(bank, slide_ids, generator)
        total.backward()
        self.optimizer.step()
        return stats
