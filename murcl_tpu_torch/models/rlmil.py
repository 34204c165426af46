"""GRU projection head and the PPO policy (counterpart of ``murcl_tpu/models/rlmil.py``).

- :class:`FullLayer`: the reference ``Full_layer``, a one-layer GRU over
  the rollout steps plus a linear head (``fc_rnn=True``). The carry is
  explicit: ``forward(x, hidden)`` returns ``(logits, new_hidden)`` and
  ``hidden=None`` restarts from zeros. The cascaded-FC mode
  (``fc_rnn=False``, ``murcl_tpu/models/rlmil.py:67-83``) carries the
  concatenated step features and classifies them with the head ``fc_t`` of
  their width; it has no logit at the restart step, so no engine runs it.
- :class:`ActorCritic`: state encoder ``state_dim -> 2048 -> hidden`` (or,
  with ``policy_conv``, a bias-free 1x1 conv to 32 channels, flatten and
  ``-> hidden``), a GRU carrying the policy's recurrent state, a sigmoid
  actor and a scalar critic. :func:`act` samples independent Gaussians of
  std ``action_std``
  around the actor's mean, clamps to [0, 1] and records the log-prob of the
  clamped action; :func:`evaluate` re-runs a rollout from a **zero** hidden
  state, as the reference does.
- :class:`PPO`: the clipped surrogate with value MSE and entropy bonus over
  normalised discounted returns, ``K_epochs`` of Adam, then ``policy_old``
  takes the policy's weights.

GRU parameters live in ``nn.GRU`` modules so the ``state_dict`` keys are the
reference's (``rnn.weight_ih_l0`` ..., ``gru.weight_ih_l0`` ...); one step
is the r, z, n gate equations of ``nn.GRUCell`` written out as f32 matmuls,
which do not go through cuDNN's RNN (that one takes TF32 by default). Init
is torch's default, as in the reference.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from murcl_tpu_torch.utils.trace import span


def _gru_step(rnn: nn.GRU, x, hidden):
    """One ``nn.GRUCell`` step with the weights of the one-layer ``rnn``."""
    i_r, i_z, i_n = F.linear(x, rnn.weight_ih_l0, rnn.bias_ih_l0).chunk(3, dim=-1)
    h_r, h_z, h_n = F.linear(hidden, rnn.weight_hh_l0, rnn.bias_hh_l0).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * hidden


class FullLayer(nn.Module):
    def __init__(self, feature_num: int, hidden_state_dim: int = 1024,
                 fc_rnn: bool = True, class_num: int = 1000):
        super().__init__()
        self.feature_num = feature_num
        self.hidden_state_dim = hidden_state_dim
        self.fc_rnn = fc_rnn
        if fc_rnn:
            self.rnn = nn.GRU(feature_num, hidden_state_dim)
            self.fc = nn.Linear(hidden_state_dim, class_num)
        else:
            # the heads of steps 2..5 all exist, as in checkpoints of either package
            for t in range(2, 6):
                setattr(self, f"fc_{t}", nn.Linear(feature_num * t, class_num))

    def forward(self, x, hidden: Optional[torch.Tensor] = None):
        with span("murcl.head"):
            if self.fc_rnn:
                if hidden is None:
                    hidden = x.new_zeros((x.shape[0], self.hidden_state_dim))
                h = _gru_step(self.rnn, x, hidden)
                return self.fc(h), h
            acc = x if hidden is None else torch.cat([hidden, x], dim=1)
            t, rest = divmod(acc.shape[1], self.feature_num)
            if rest or not 1 <= t <= 5:
                raise ValueError(f"cascaded FullLayer supports T<=5, got width {acc.shape[1]}")
            return (None if t == 1 else getattr(self, f"fc_{t}")(acc)), acc

    def zero_carry(self, batch: int, device=None) -> Optional[torch.Tensor]:
        """The restart carry: zeros for the GRU, ``None`` for the cascaded head."""
        if not self.fc_rnn:
            return None
        return torch.zeros((batch, self.hidden_state_dim), device=device)


class _Conv1x1(nn.Module):
    """A bias-free 1x1 convolution, ``(B, C, h, w) -> (B, out, h, w)``, as a
    product over channels (f32 without TF32, as every policy product; a
    ``Conv2d`` would run cuDNN). Its weight has ``Conv2d``'s shape and
    initialisation."""

    def __init__(self, channels: int, out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, channels, 1, 1))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        return F.linear(x.movedim(1, -1), self.weight.flatten(1)).movedim(-1, 1)


class ActorCritic(nn.Module):
    """``forward(state (B, S), hidden (B, H))`` -> ``(action_mean (B, K),
    value (B,), new_hidden)``. Keys: ``state_encoder.0``, ``state_encoder.2``,
    ``gru``, ``actor.0``, ``critic.0`` (``murcl_tpu/engine/torch_import.py``
    ``ACTOR_CRITIC_MAP``).

    ``policy_conv`` encodes a feature map ``(B, C, h, w)``, or the engines'
    ``(B, C)`` state as a 1 x 1 map (``murcl_tpu/models/rlmil.py:112-118``):
    ``state_encoder.0`` is a bias-free 1x1 conv ``C -> 32`` (a ``Conv2d``'s
    weight, run as a product over channels), then ReLU, flatten in torch's
    ``(32, h, w)`` order, ``state_encoder.3`` (``Linear(32 h w, hidden)``)
    and ReLU. ``C`` is ``feature_dim`` (default ``state_dim``) and ``h w =
    state_dim / C``.
    """

    def __init__(self, state_dim: int, hidden_state_dim: int = 1024, action_size: int = 2,
                 action_std: float = 0.1, policy_conv: bool = False,
                 feature_dim: Optional[int] = None):
        super().__init__()
        self.hidden_state_dim = hidden_state_dim
        self.action_size = action_size
        self.action_std = action_std
        self.policy_conv = policy_conv
        if policy_conv:
            channels = feature_dim or state_dim
            if state_dim % channels:
                raise ValueError(f"state_dim {state_dim} is not a multiple of the conv "
                                 f"state's {channels} channels")
            self.state_encoder = nn.Sequential(
                _Conv1x1(channels, 32), nn.ReLU(), nn.Flatten(),
                nn.Linear(32 * (state_dim // channels), hidden_state_dim), nn.ReLU())
        else:
            self.state_encoder = nn.Sequential(nn.Linear(state_dim, 2048), nn.ReLU(),
                                               nn.Linear(2048, hidden_state_dim), nn.ReLU())
        self.gru = nn.GRU(hidden_state_dim, hidden_state_dim)
        self.actor = nn.Sequential(nn.Linear(hidden_state_dim, action_size), nn.Sigmoid())
        self.critic = nn.Sequential(nn.Linear(hidden_state_dim, 1))

    def _encode(self, state):
        if not self.policy_conv:
            state = state.reshape(state.shape[0], -1)
        elif state.dim() != 4:  # the engines' (B, C) state, a 1 x 1 map
            state = state.reshape(state.shape[0], -1, 1, 1)
        return self.state_encoder(state)

    def forward(self, state, hidden):
        h = _gru_step(self.gru, self._encode(state), hidden)
        return self.actor(h), self.critic(h)[..., 0], h


def _diag_gaussian_logprob(x, mean, std: float):
    k = x.shape[-1]
    z = (x - mean) / std
    return -0.5 * (z * z).sum(dim=-1) - k * math.log(std) - 0.5 * k * math.log(2.0 * math.pi)


def _diag_gaussian_entropy(k: int, std: float) -> float:
    return 0.5 * k * math.log(2.0 * math.pi * math.e) + k * math.log(std)


class PolicyStep(NamedTuple):
    """What the policy records per rollout step (the reference ``Memory``)."""

    state: torch.Tensor  # (B, S) state the action was taken from
    action: torch.Tensor  # (B, K) clamped sampled action
    logprob: torch.Tensor  # (B,)


class Rollout(NamedTuple):
    """Stacked policy steps and rewards, leading dim T-1."""

    states: torch.Tensor  # (T-1, B, S)
    actions: torch.Tensor  # (T-1, B, K)
    logprobs: torch.Tensor  # (T-1, B)
    rewards: torch.Tensor  # (T-1, B)


@torch.no_grad()
def act(model: ActorCritic, state, hidden, generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None):
    """One policy step: ``(action (B, K), new_hidden, PolicyStep)``.

    ``noise`` is a standard-normal ``(B, K)`` draw (tests inject it);
    otherwise it is drawn from ``generator`` on that generator's device. The
    action is ``clamp(mean + action_std * noise, 0, 1)`` and the log-prob is
    that of the clamped action (``murcl_tpu/models/rlmil.py:179-185``).
    """
    with span("murcl.policy"):
        mean, _, new_hidden = model(state, hidden)
        if noise is None:
            dev = generator.device if generator is not None else mean.device
            noise = torch.randn(mean.shape, generator=generator, device=dev)
        clamped = (mean + noise.to(mean.device) * model.action_std).clamp(0.0, 1.0)
        logprob = _diag_gaussian_logprob(clamped, mean, model.action_std)
        return clamped, new_hidden, PolicyStep(state=state, action=clamped, logprob=logprob)


def evaluate(model: ActorCritic, states, actions):
    """Re-run the policy over ``states (T, B, S)`` from a zero hidden state:
    ``(logprobs, values, entropy)``, each ``(T, B)``."""
    t, b = states.shape[0], states.shape[1]
    hidden = states.new_zeros((b, model.hidden_state_dim))
    means, values = [], []
    for i in range(t):
        mean, value, hidden = model(states[i], hidden)
        means.append(mean)
        values.append(value)
    logprobs = _diag_gaussian_logprob(actions, torch.stack(means), model.action_std)
    entropy = torch.full((t, b), _diag_gaussian_entropy(model.action_size, model.action_std),
                         device=states.device)
    return logprobs, torch.stack(values), entropy


class PPO:
    """Clipped PPO over the rollout buffer (``murcl_tpu/models/rlmil.py`` ``PPO``).

    ``policy`` trains; ``policy_old`` is the action source and takes the
    policy's weights after each :meth:`update`. Under data parallelism every
    rank runs :meth:`update` on the same gathered rollout, from the same
    weights and Adam state, so the policies stay bitwise equal across ranks
    (``tests/test_torch_dp.py`` and ``chip_smoke.py`` check it).
    """

    def __init__(self, state_dim: int, hidden_state_dim: int = 1024, policy_conv: bool = False,
                 action_std: float = 0.1, lr: float = 3e-4, betas=(0.9, 0.999),
                 gamma: float = 0.7, K_epochs: int = 1, eps_clip: float = 0.2,
                 action_size: int = 2, feature_dim: Optional[int] = None):
        self.gamma = gamma
        self.eps_clip = eps_clip
        self.K_epochs = K_epochs
        self.policy = ActorCritic(state_dim, hidden_state_dim, action_size, action_std,
                                  policy_conv, feature_dim)
        self.policy_old = copy.deepcopy(self.policy)
        self.optimizer = torch.optim.Adam(self.policy.parameters(), lr=lr, betas=betas,
                                          eps=1e-8)

    def to(self, device) -> "PPO":
        """Move both policies; call before the first :meth:`update`."""
        self.policy.to(device)
        self.policy_old.to(device)
        return self

    def load_policy(self, state_dict) -> None:
        """Set policy and ``policy_old`` to ``state_dict``."""
        self.policy.load_state_dict(state_dict)
        self.policy_old.load_state_dict(state_dict)

    def zero_hidden(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch, self.policy.hidden_state_dim), device=device)

    def discounted_returns(self, rewards):
        """Reverse discounted sum over the steps of ``rewards (T, B)``,
        normalised by the mean and unbiased std of all elements + 1e-5."""
        returns = torch.empty_like(rewards)
        g = torch.zeros_like(rewards[0])
        for t in range(rewards.shape[0] - 1, -1, -1):
            g = rewards[t] + self.gamma * g
            returns[t] = g
        std = returns.std() if returns.numel() > 1 else returns.new_zeros(())
        return (returns - returns.mean()) / (std + 1e-5)

    def update(self, rollout: Rollout) -> torch.Tensor:
        """``K_epochs`` of the clipped loss with Adam; returns the last loss."""
        with span("murcl.ppo_update"):
            returns = self.discounted_returns(rollout.rewards.detach())
            states, actions = rollout.states.detach(), rollout.actions.detach()
            old_logprobs = rollout.logprobs.detach()
            loss = returns.new_zeros(())
            for _ in range(self.K_epochs):
                logprobs, values, entropy = evaluate(self.policy, states, actions)
                ratios = torch.exp(logprobs - old_logprobs)
                advantages = returns - values.detach()
                surr1 = ratios * advantages
                surr2 = torch.clamp(ratios, 1.0 - self.eps_clip,
                                    1.0 + self.eps_clip) * advantages
                loss = (-torch.minimum(surr1, surr2).mean()
                        + 0.5 * ((values - returns) ** 2).mean() - 0.01 * entropy.mean())
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
            self.policy_old.load_state_dict(self.policy.state_dict())
            return loss.detach()
