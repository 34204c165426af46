#!/usr/bin/env python
"""PPO learning check: can stage 2 learn where the signal lives?
(Counterpart of ``scripts/ppo_sanity.py``.)

A synthetic bank where the action matters: 32 slides of 240 patches in 4
contiguous clusters, and in every slide of class 1 only the first 30% of
cluster 0 carries the class signal (``6 / sqrt(dim)`` on every feature). A
random window hits it about a third of the time; a policy whose action on
cluster 0 goes to 0 hits it always. Stage 1 warms ABMIL and the GRU head on
random windows (150 Adam steps of 8 slides); stage 2 trains the PPO policy
(15 epochs of 8 steps) on the supervised engine's rollouts. Prints one JSON
line with the JAX script's keys. Learning shows in three directions,
:func:`directions`: confidence with the policy's windows above confidence
with random windows, the probe's mean action falling, and the mean reward of
the last five epochs above that of the first five.

The draws follow the JAX script: the bank from ``default_rng(0)`` and the
slide ids from ``default_rng(1)``, both packages drawing the same numbers;
the actions, the policy noise and the dropout from one CPU generator per JAX
key (the stage-1 step, ``1000 + 8 epoch + step`` in stage 2, 99 for the
confidences), the weights' init from torch's generator at the JAX script's
seeds (0 for the aggregator and head, 2 for the policy). Torch's streams are
not JAX's, so the two agree in direction, not in value.

Widths: ``--dim/--L/--D`` default to ABMIL's in the port (512, 512, 128).
On the card K7 takes L and D in multiples of 128 only, so the JAX script's
(32, 32, 8) runs on ``--device cpu`` alone. The bank's shape is the JAX
script's at every width. At the JAX script's widths the three directions
hold under any rounding; at ABMIL's, stage 1 alone reaches a confidence of
0.93-0.998 with random windows, the policy has almost nothing left to gain,
and which directions hold is decided by rounding (``PERF.md``, section 6).

    python -m murcl_tpu_torch.scripts.ppo_sanity             # cuda:0
    python -m murcl_tpu_torch.scripts.ppo_sanity --device cpu --dim 32 --L 32 --D 8
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, replace
from typing import Dict, List

import numpy as np
import torch

from murcl_tpu_torch.data.bank import FeatureBank, bank_from_arrays
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.losses import label_confidence
from murcl_tpu_torch.engine.optim import make_optimizer
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.models import PPO, FullLayer, build_aggregator

SLIDES, N, K, FEAT, T, B = 32, 240, 4, 24, 4, 8
STAGE1_STEPS, EPOCHS, EPOCH_STEPS = 150, 15, 8
HIDDEN = 32  # the GRU head's and the policy's hidden width


def build_positional_bank(dim: int = 32) -> FeatureBank:
    """The JAX script's ``build_positional_bank`` at feature width ``dim``,
    draw for draw (its ``DIM`` is 32)."""
    rng = np.random.default_rng(0)
    per = N // K
    feats, clusters, labels = [], [], []
    for i in range(SLIDES):
        label = i % 2
        f = rng.normal(size=(N, dim)).astype(np.float32)
        cl = [list(range(k * per, (k + 1) * per)) for k in range(K)]
        if label == 1:
            f[cl[0][: (3 * per) // 10]] += 6.0 / np.sqrt(dim)
        feats.append(f)
        clusters.append(cl)
        labels.append(label)
    return bank_from_arrays(feats, clusters, labels)


def slide_batches():
    """The JAX script's slide ids: ``B`` distinct slides per step, all drawn
    from one ``default_rng(1)``, stage 1's steps first."""
    rng = np.random.default_rng(1)
    while True:
        yield rng.choice(SLIDES, B, replace=False)


@dataclass
class Sanity:
    """One run's unrounded readings and its final weights."""

    conf_random: float
    conf_policy: float
    stage1_losses: List[float]  # the loss of every stage-1 step
    rewards: List[float]  # stage-2 mean reward per epoch
    actions: List[float]  # the probe's mean action after each epoch
    weights: Dict[str, torch.Tensor]  # model.*, fc.*, policy.*

    def report(self) -> dict:
        """The JAX script's JSON line."""
        return {
            "signal": "first 30% of cluster 0",
            "confidence_random_windows": round(self.conf_random, 4),
            "confidence_policy_windows": round(self.conf_policy, 4),
            "stage1_final_loss": self.stage1_losses[-1],
            "stage2_reward_first_epoch": self.rewards[0],
            "stage2_reward_last_epoch": self.rewards[-1],
            "rewards_per_epoch": [round(r, 4) for r in self.rewards],
            "mean_action_first": round(self.actions[0], 3),
            "mean_action_last": round(self.actions[-1], 3),
        }


def directions(report: dict) -> Dict[str, bool]:
    """The three directions a run that learns holds."""
    r = report["rewards_per_epoch"]
    return {"policy_windows_above_random": (report["confidence_policy_windows"]
                                            > report["confidence_random_windows"]),
            "mean_action_falls": report["mean_action_last"] < report["mean_action_first"],
            "last_five_rewards_above_first_five": float(np.mean(r[-5:])) > float(np.mean(r[:5]))}


def run(device="cuda:0", dim: int = 512, L: int = 512, D: int = 128,
        compute_dtype: str = "float32") -> Sanity:
    """Stage 1, then stage 2, on ``device`` (no fallback: a CUDA device that
    is absent raises)."""
    dev = torch.device(device)
    cdtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    bank = build_positional_bank(dim).to(dev, dtype=cdtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, feature_num = build_aggregator("ABMIL", dim, arch_setting={"L": L, "D": D})
        fc = FullLayer(feature_num=feature_num, hidden_state_dim=HIDDEN, class_num=2)
    model, fc = model.to(dev), fc.to(dev)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    slides = slide_batches()

    def batch():
        return torch.as_tensor(next(slides), device=dev)

    # stage 1: warm the aggregator and the head on random windows
    cfg1 = RolloutConfig(arch="ABMIL", T=T, feat_size=FEAT, num_clusters=K, train_stage=1,
                         compute_dtype=compute_dtype)
    opt = make_optimizer(model, fc, "Adam", backbone_lr=3e-3, fc_lr=3e-3, wdecay=0.0)
    eng1 = SupervisedEngine(cfg1, model, fc, optimizer=opt)
    losses = [float(eng1.train_step(bank, batch(), gen(step)).loss)
              for step in range(STAGE1_STEPS)]

    # stage 2: PPO learns the windows
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        ppo = PPO(state_dim=feature_num, hidden_state_dim=HIDDEN, action_size=K,
                  action_std=0.3, lr=3e-4, gamma=0.1, K_epochs=3)
    ppo.to(dev)
    eng2 = SupervisedEngine(replace(cfg1, train_stage=2), model, fc, ppo=ppo)

    def mean_confidence(engine) -> float:
        """Mean true-class softmax probability over all slides with this
        engine's actions (random in stage 1, the policy's in stage 2)."""
        ids = torch.arange(SLIDES, device=dev)
        st = engine.eval_step(bank, ids, gen(99))
        return float(label_confidence(st.logits, bank.labels[ids]).mean())

    conf_random = mean_confidence(eng1)
    rewards, actions = [], []
    for epoch in range(EPOCHS):
        ep = [float(eng2.train_step(bank, batch(), gen(1000 + epoch * EPOCH_STEPS + step))
                    .rewards.sum()) for step in range(EPOCH_STEPS)]
        rewards.append(float(np.mean(ep)))
        with torch.no_grad():  # the deterministic action on a probe state
            mean, _, _ = ppo.policy(torch.zeros((1, feature_num), device=dev),
                                    ppo.zero_hidden(1, dev))
        actions.append(float(mean.mean()))
    conf_policy = mean_confidence(eng2)

    weights = {f"{part}.{k}": v.detach().clone() for part, mod in
               (("model", model), ("fc", fc), ("policy", ppo.policy))
               for k, v in mod.state_dict().items()}
    return Sanity(conf_random, conf_policy, losses, rewards, actions, weights)


def main(device="cuda:0", dim: int = 512, L: int = 512, D: int = 128,
         compute_dtype: str = "float32") -> dict:
    """Run the check, print its JSON line and return it."""
    report = run(device, dim, L, D, compute_dtype).report()
    print(json.dumps(report))
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain path)")
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--dim", type=int, default=512, help="feature width of the bank")
    ap.add_argument("--L", type=int, default=512, help="ABMIL's embedding width")
    ap.add_argument("--D", type=int, default=128, help="ABMIL's attention width")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
