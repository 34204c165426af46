"""Port's ActorCritic / act / evaluate / PPO vs the JAX package's, same weights.

Weights move with ``policy_from_jax`` (and back, exactly). ``act`` takes the
standard-normal noise JAX draws from its key, injected. In f32: actions,
log-probs, values, entropies and normalised returns to rtol 1e-5; after one
``PPO.update`` (K_epochs 3) the loss to rtol 1e-5 and every weight to rtol
1e-5 plus 2e-6 absolute, since an Adam step is about lr wherever |grad| >> eps
and a gradient that agrees to ~1e-6 relative moves the step by up to that
much where |grad| is near eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu.models.rlmil import Rollout as JaxRollout
from murcl_tpu.models.rlmil import act as jax_act
from murcl_tpu.models.rlmil import evaluate as jax_evaluate
from murcl_tpu_torch.engine.weights import jax_from_policy, policy_from_jax
from murcl_tpu_torch.models.rlmil import PPO, Rollout, act, evaluate

S, H, K, B, T = 12, 16, 3, 4, 3
KW = dict(hidden_state_dim=H, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=3, action_size=K)


def _setup(seed=0):
    jppo = JaxPPO(state_dim=S, **KW)
    state = jppo.init(jax.random.PRNGKey(seed), jnp.zeros((B, S)))
    ppo = PPO(S, **KW)
    ppo.load_policy(policy_from_jax(state.params))
    return jppo, state, ppo


def _close(got, want, rtol=1e-5, atol=1e-7, name=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def test_policy_weights_round_trip():
    _, state, ppo = _setup()
    back = jax_from_policy(ppo.policy.state_dict())
    want_l, want_t = jax.tree_util.tree_flatten(state.params)
    got_l, got_t = jax.tree_util.tree_flatten(back)
    assert want_t == got_t
    for a, b in zip(want_l, got_l):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_act_and_evaluate_match_jax():
    jppo, state, ppo = _setup(1)
    rng = np.random.default_rng(1)
    st = rng.normal(size=(B, S)).astype(np.float32)
    carry = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(5)
    j_action, j_carry, j_step = jax_act(jppo.model, state.params, jnp.asarray(st),
                                        jnp.asarray(carry), key)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (B, K))))
    action, new_carry, step = act(ppo.policy, torch.tensor(st), torch.tensor(carry),
                                  noise=noise)
    _close(action, j_action, name="action")
    _close(new_carry, j_carry, name="carry")
    _close(step.logprob, j_step.logprob, name="logprob")

    states = rng.normal(size=(T, B, S)).astype(np.float32)
    actions = rng.random((T, B, K)).astype(np.float32)
    want = jax_evaluate(jppo.model, state.params, jnp.asarray(states), jnp.asarray(actions))
    got = evaluate(ppo.policy, torch.tensor(states), torch.tensor(actions))
    for name, g, w in zip(("logprobs", "values", "entropy"), got, want):
        _close(g, w, name=name)


def test_discounted_returns_match_jax():
    jppo, _, ppo = _setup()
    rewards = np.random.default_rng(2).normal(size=(T, B)).astype(np.float32)
    _close(ppo.discounted_returns(torch.tensor(rewards)),
           jppo.discounted_returns(jnp.asarray(rewards)))


def test_update_matches_jax():
    jppo, state, ppo = _setup(3)
    rng = np.random.default_rng(3)
    arrays = (rng.normal(size=(T, B, S)), rng.random((T, B, K)),
              rng.normal(size=(T, B)) - 2.0, rng.normal(size=(T, B)) * 0.1)
    arrays = [a.astype(np.float32) for a in arrays]
    new_state, jloss = jppo.update(state, JaxRollout(*map(jnp.asarray, arrays)))
    loss = ppo.update(Rollout(*map(torch.tensor, arrays)))
    _close(loss, jloss, name="loss")
    want = policy_from_jax(new_state.params)
    for name, p in ppo.policy.state_dict().items():
        _close(p, want[name], atol=2e-6, name=name)
        assert torch.equal(ppo.policy_old.state_dict()[name], p), name
