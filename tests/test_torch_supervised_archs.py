"""Port's supervised engine for ABMIL and DSMIL vs the JAX ``SupervisedEngine``.

The same weights (``params_from_jax``) and data (numpy seeds) through both
engines, f32, dropout 0, a padded batch (last slide repeated, ``valid``
false); actions and the policy noise injected as
``tests/test_torch_supervised.py`` does for CLAM_SB:

- stage 1, ``rollout_batched`` against ``_rollout_batched(..., actions=)``:
  step losses to rtol 1e-5, every parameter's gradient to rtol 1e-4, the
  rollout to rtol 1e-5;
- one stage-1 train step: step losses to rtol 1e-5, every weight after one
  Adam step (the CLI's rates, 1e-4) within 1e-4 of JAX's;
- stage 3, ``rollout_sequential`` against ``_rollout_sequential``;
- DSMIL under ``--train_method linear``: the whole aggregator is frozen, so
  only the GRU head moves, as JAX's Adam moves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.engine import BankArrays
from murcl_tpu.engine import RolloutConfig as JaxConfig
from murcl_tpu.engine import SupervisedEngine as JaxEngine
from murcl_tpu.engine.optim import linear_eval_frozen_paths
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.dsmil import MILNet as JaxMILNet
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.optim import (fill_missing_grads, freeze_for_linear_eval,
                                          make_optimizer, step)
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax
from murcl_tpu_torch.models import ABMIL, PPO, FullLayer, MILNet

DIM, K, B, T, FEAT, HID, PHID, L, D = 16, 3, 4, 3, 24, 32, 16, 32, 16
LR = 1e-4  # the CLI's backbone_lr and fc_lr
PPO_KW = dict(hidden_state_dim=PHID, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=2,
              action_size=K)
ARCHS = ("ABMIL", "DSMIL")


def _data(seed):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(6):
        n = int(rng.integers(20, 60))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    labels = [0, 1, 1, 0, 1, 0]
    ids = np.array([4, 1, 0, 0], np.int32)  # last slide repeated: a padded batch
    valid = np.array([True, True, True, False])
    return feats, clusters, labels, ids, valid


def _models(arch):
    """``(JAX aggregator, port aggregator, its bag-embedding width)``."""
    if arch == "ABMIL":
        return JaxABMIL(dim_in=DIM, L=L, D=D, dim_out=2), ABMIL(dim_in=DIM, L=L, D=D), L
    return JaxMILNet(dim_feat=DIM, num_classes=2), MILNet(dim_feat=DIM, num_classes=2), DIM


def _engines(arch, stage, seed=0, linear=False):
    """Both engines on the same weights; ``linear`` freezes as
    ``--train_method linear`` does."""
    feats, clusters, labels, ids, valid = _data(seed)
    jmodel, model, width = _models(arch)
    jcfg = JaxConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=stage, num_classes=2, remat="none")
    jppo = JaxPPO(state_dim=width, **PPO_KW) if stage != 1 else None
    frozen = linear_eval_frozen_paths(arch) if linear else None
    tx = (jax_make_optimizer("Adam", backbone_lr=LR, fc_lr=LR, frozen_model_paths=frozen)
          if stage != 2 else None)
    jengine = JaxEngine(jcfg, jmodel, JaxFullLayer(feature_num=width, hidden_state_dim=HID,
                                                   class_num=2), ppo=jppo, tx=tx)
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)),
                                 jnp.zeros((B,), jnp.int32))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, width))) if jppo else None

    fc = FullLayer(feature_num=width, hidden_state_dim=HID, class_num=2)
    msd, fsd = params_from_jax(params["model"], params["fc"], arch=arch)
    model.load_state_dict(msd)
    fc.load_state_dict(fsd)
    ppo = None
    if stage != 1:
        ppo = PPO(width, **PPO_KW)
        ppo.load_policy(policy_from_jax(pstate.params))
    cfg = RolloutConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, train_stage=stage,
                        num_classes=2)
    if linear:
        freeze_for_linear_eval(model, arch)
    opt = make_optimizer(model, fc, "Adam", backbone_lr=LR, fc_lr=LR) if stage != 2 else None
    engine = SupervisedEngine(cfg, model, fc, ppo=ppo, optimizer=opt)
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    bank = bank_from_arrays(feats, clusters, labels)
    lab = np.asarray(labels)[ids]
    return dict(arch=arch, jengine=jengine, params=params, pstate=pstate, engine=engine,
                jbank=jbank, bank=bank, ids=ids, valid=valid, labels=lab)


def _torch_args(e):
    return (e["bank"], torch.tensor(e["ids"], dtype=torch.int64), torch.tensor(e["labels"]),
            torch.tensor(e["valid"]), torch.Generator())


def _batched(e, actions, rng=jax.random.PRNGKey(3)):
    """JAX's stage-1 loss, stats, rollout and gradients, then the port's
    rollout with its gradients filled."""
    def loss_fn(p):
        return e["jengine"]._rollout_batched(
            p, e["jbank"], jnp.asarray(e["ids"]), jnp.asarray(e["labels"]),
            jnp.asarray(e["valid"]), rng, True, actions=jnp.asarray(actions))

    (_, (jstats, jrollout)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(e["params"])
    total, stats, rollout = e["engine"].rollout_batched(*_torch_args(e),
                                                        actions=torch.tensor(actions))
    total.backward()
    return jstats, jrollout, jgrads, stats, rollout


def _sequential(e, rng=jax.random.PRNGKey(4)):
    """JAX's stage-3 rollout and gradients, then the port's with the JAX
    engine's draws, rebuilt from its key splits, injected."""
    def loss_fn(p):
        return e["jengine"]._rollout_sequential(
            p, e["pstate"].old_params, e["jbank"], jnp.asarray(e["ids"]),
            jnp.asarray(e["labels"]), jnp.asarray(e["valid"]), rng, True)

    (_, (jstats, jrollout)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(e["params"])
    rest, r_act0, _ = jax.random.split(rng, 3)
    actions0 = jax.random.uniform(r_act0, (B, K))
    noise = [jax.random.normal(jax.random.split(r)[0], (B, K))
             for r in jax.random.split(rest, T - 1)]
    total, stats, rollout = e["engine"].rollout_sequential(
        *_torch_args(e), actions0=torch.tensor(np.asarray(actions0)),
        noise=torch.tensor(np.stack([np.asarray(n) for n in noise])))
    total.backward()
    return jstats, jrollout, jgrads, stats, rollout


def _named(engine):
    return ([(f"model.{k}", p) for k, p in engine.model.named_parameters()]
            + [(f"fc.{k}", p) for k, p in engine.fc.named_parameters()])


def _compare_grads(e, jgrads):
    gm, gf = params_from_jax(jgrads["model"], jgrads["fc"], arch=e["arch"])
    want = {**{f"model.{k}": v for k, v in gm.items()}, **{f"fc.{k}": v for k, v in gf.items()}}
    named = _named(e["engine"])
    fill_missing_grads(p for _, p in named)  # dead heads: as engine.optim.step
    for name, p in named:
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def _compare(jstats, jrollout, jgrads, stats, rollout, e):
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    _compare_grads(e, jgrads)
    for name in ("states", "actions", "logprobs", "rewards"):
        np.testing.assert_allclose(getattr(rollout, name).numpy(),
                                   np.asarray(getattr(jrollout, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _actions(seed):
    return np.random.default_rng(seed).random((T, B, K)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage1_batched_rollout_matches_jax(arch):
    e = _engines(arch, 1)
    _compare(*_batched(e, _actions(5)), e)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage1_train_step_matches_jax(arch):
    e = _engines(arch, 1, seed=2)
    params = e["params"]
    jstats, _, jgrads, stats, _ = _batched(e, _actions(7))
    updates, _ = e["jengine"].tx.update(jgrads, e["jengine"].init_state(params).opt_state,
                                        params)
    new = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    want_m, want_f = params_from_jax(new["model"], new["fc"], arch=arch)
    want = {**{f"model.{k}": v for k, v in want_m.items()},
            **{f"fc.{k}": v for k, v in want_f.items()}}
    step(e["engine"].optimizer)
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    for name, p in _named(e["engine"]):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage3_sequential_rollout_matches_jax(arch):
    e = _engines(arch, 3, seed=1)
    _compare(*_sequential(e), e)


def test_dsmil_linear_step_moves_only_fc():
    e = _engines("DSMIL", 1, seed=6, linear=True)
    params = e["params"]
    engine = e["engine"]
    before = {k: p.detach().clone() for k, p in _named(engine)}
    jstats, _, jgrads, stats, _ = _batched(e, _actions(10))
    updates, _ = e["jengine"].tx.update(jgrads, e["jengine"].init_state(params).opt_state,
                                        params)
    new = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    want_m, want_f = params_from_jax(new["model"], new["fc"], arch="DSMIL")
    step(engine.optimizer)
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    moved = {k for k, p in _named(engine) if not torch.equal(p.detach(), before[k])}
    assert moved == {f"fc.{k}" for k, _ in engine.fc.named_parameters()}
    for k, p in engine.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want_m[k].numpy(), err_msg=k)
    for k, p in engine.fc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_f[k].numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=k)
