"""Port's supervised engine vs the JAX ``SupervisedEngine``, same weights.

Stage 1: ``rollout_batched`` against ``_rollout_batched(..., actions=)``.
Stage 3: ``rollout_sequential`` against ``_rollout_sequential``, with the
t=0 actions and the per-step policy noise rebuilt from the JAX engine's own
key splits (``engine/supervised.py:398-399,416,433``, ``models/rlmil.py:179``)
and injected. f32, dropout 0, a padded batch (last slide repeated, ``valid``
false): step losses to rtol 1e-5, every live parameter's gradient to rtol
1e-4, rollout states/actions/log-probs/rewards to rtol 1e-5 (the rewards
plus 1e-6 absolute: they are differences of confidences near 0.5). Stage 2
leaves the aggregator unchanged and moves the policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.engine import BankArrays
from murcl_tpu.engine import RolloutConfig as JaxConfig
from murcl_tpu.engine import SupervisedEngine as JaxEngine
from murcl_tpu.engine.optim import linear_eval_frozen_paths
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.optim import (fill_missing_grads, freeze_for_linear_eval,
                                          make_optimizer, step)
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax
from murcl_tpu_torch.models import CLAM_SB, PPO, FullLayer

DIM, K, B, T, FEAT, HID, PHID, L1, L2 = 16, 3, 4, 3, 24, 32, 16, 32, 16
CLAM_KW = dict(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, k_sample=4, n_classes=2,
               subtyping=True)
PPO_KW = dict(hidden_state_dim=PHID, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=2,
              action_size=K)


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (L1, L2))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (L1, L2))


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


def _engines(stage, seed=0, linear=False):
    """Both engines on the same weights; ``linear`` freezes as
    ``--train_method linear`` does, with lr 1e-3 on both sides."""
    feats, clusters, labels, ids, valid = _data(seed)
    jcfg = JaxConfig(arch="CLAM_SB", T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=stage, num_classes=2, bag_weight=0.7, remat="none")
    jppo = JaxPPO(state_dim=L1, **PPO_KW) if stage != 1 else None
    frozen = linear_eval_frozen_paths("CLAM_SB") if linear else None
    tx = (jax_make_optimizer("Adam", backbone_lr=1e-3, fc_lr=1e-3, frozen_model_paths=frozen)
          if stage != 2 else None)
    jengine = JaxEngine(jcfg, JaxCLAM(**CLAM_KW),
                        JaxFullLayer(feature_num=L1, hidden_state_dim=HID, class_num=2),
                        ppo=jppo, tx=tx)
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)),
                                 jnp.zeros((B,), jnp.int32))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, L1))) if jppo else None

    model, fc = CLAM_SB(**CLAM_KW), FullLayer(feature_num=L1, hidden_state_dim=HID, class_num=2)
    msd, fsd = params_from_jax(params["model"], params["fc"])
    model.load_state_dict(msd)
    fc.load_state_dict(fsd)
    ppo = None
    if stage != 1:
        ppo = PPO(L1, **PPO_KW)
        ppo.load_policy(policy_from_jax(pstate.params))
    cfg = RolloutConfig(arch="CLAM_SB", T=T, feat_size=FEAT, num_clusters=K, train_stage=stage,
                        num_classes=2, bag_weight=0.7)
    if linear:
        freeze_for_linear_eval(model, "CLAM_SB")
    lrs = dict(backbone_lr=1e-3, fc_lr=1e-3) if linear else {}
    opt = make_optimizer(model, fc, "Adam", **lrs) if stage != 2 else None
    engine = SupervisedEngine(cfg, model, fc, ppo=ppo, optimizer=opt)
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    bank = bank_from_arrays(feats, clusters, labels)
    lab = np.asarray(labels)[ids]
    return dict(jengine=jengine, params=params, pstate=pstate, engine=engine, jbank=jbank,
                bank=bank, ids=ids, valid=valid, labels=lab)


def _compare_grads(engine, jgrads):
    gm, gf = params_from_jax(jgrads["model"], jgrads["fc"])
    named = [(k, p, gm[k]) for k, p in engine.model.named_parameters()]
    named += [(k, p, gf[k]) for k, p in engine.fc.named_parameters()]
    fill_missing_grads(p for _, p, _ in named)  # the dead bag head: as engine.optim.step
    for name, p, want in named:
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def _compare_rollout(rollout, jrollout):
    for name in ("states", "actions", "logprobs"):
        np.testing.assert_allclose(getattr(rollout, name).numpy(),
                                   np.asarray(getattr(jrollout, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(rollout.rewards.numpy(), np.asarray(jrollout.rewards),
                               rtol=1e-5, atol=1e-6)


def _torch_args(e):
    return (e["bank"], torch.tensor(e["ids"], dtype=torch.int64), torch.tensor(e["labels"]),
            torch.tensor(e["valid"]), torch.Generator())


def test_stage1_batched_rollout_matches_jax(tiny_clam):
    e = _engines(1)
    actions = np.random.default_rng(5).random((T, B, K)).astype(np.float32)
    rng = jax.random.PRNGKey(3)

    def loss_fn(p):
        return e["jengine"]._rollout_batched(
            p, e["jbank"], jnp.asarray(e["ids"]), jnp.asarray(e["labels"]),
            jnp.asarray(e["valid"]), rng, True, actions=jnp.asarray(actions))

    (_, (jstats, jrollout)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(e["params"])
    engine = e["engine"]
    total, stats, rollout = engine.rollout_batched(*_torch_args(e),
                                                   actions=torch.tensor(actions))
    total.backward()
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    _compare_grads(engine, jgrads)
    _compare_rollout(rollout, jrollout)


def test_stage1_linear_eval_step_matches_jax(tiny_clam):
    """One ``--train_method linear`` stage-1 step: the trunk (JAX's ``fc``),
    ``classifiers`` and ``instance_classifiers`` move as JAX's Adam moves
    them (the dead ``classifiers`` by the decay alone), the attention net
    stays put, on both sides."""
    e = _engines(1, seed=3, linear=True)
    actions = np.random.default_rng(6).random((T, B, K)).astype(np.float32)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return e["jengine"]._rollout_batched(
            p, e["jbank"], jnp.asarray(e["ids"]), jnp.asarray(e["labels"]),
            jnp.asarray(e["valid"]), rng, True, actions=jnp.asarray(actions))

    params = e["params"]
    (_, (jstats, _)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = e["jengine"].tx.update(jgrads, e["jengine"].init_state(params).opt_state,
                                        params)
    new = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    want_m, want_f = params_from_jax(new["model"], new["fc"])

    engine = e["engine"]
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    total, stats, _ = engine.rollout_batched(*_torch_args(e), actions=torch.tensor(actions))
    total.backward()
    step(engine.optimizer)
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    moved = set()
    for name, p in engine.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_m[name].numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=name)
        if not torch.equal(p.detach(), before[name]):
            moved.add(name.rsplit(".", 1)[0])
    assert moved == {"attention_net.0", "classifiers", "instance_classifiers.0",
                     "instance_classifiers.1"}
    for name, p in engine.fc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_f[name].numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=name)


def test_stage3_sequential_rollout_matches_jax(tiny_clam):
    e = _engines(3, seed=1)
    rng = jax.random.PRNGKey(4)

    def loss_fn(p):
        return e["jengine"]._rollout_sequential(
            p, e["pstate"].old_params, e["jbank"], jnp.asarray(e["ids"]),
            jnp.asarray(e["labels"]), jnp.asarray(e["valid"]), rng, True)

    (_, (jstats, jrollout)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(e["params"])
    # the JAX engine's draws, rebuilt from its key splits
    rest, r_act0, _ = jax.random.split(rng, 3)
    actions0 = jax.random.uniform(r_act0, (B, K))
    noise = [jax.random.normal(jax.random.split(r)[0], (B, K))
             for r in jax.random.split(rest, T - 1)]
    engine = e["engine"]
    total, stats, rollout = engine.rollout_sequential(
        *_torch_args(e), actions0=torch.tensor(np.asarray(actions0)),
        noise=torch.tensor(np.stack([np.asarray(n) for n in noise])))
    total.backward()
    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    _compare_grads(engine, jgrads)
    _compare_rollout(rollout, jrollout)


def test_stage2_trains_policy_only(tiny_clam):
    e = _engines(2, seed=2)
    engine = e["engine"]
    agg = {k: v.clone() for k, v in engine.model.state_dict().items()}
    agg.update({f"fc.{k}": v.clone() for k, v in engine.fc.state_dict().items()})
    pol = {k: v.clone() for k, v in engine.ppo.policy.state_dict().items()}
    bank, ids, _, valid, gen = _torch_args(e)
    stats = engine.train_step(bank, ids, gen.manual_seed(0), valid=valid)
    assert torch.isfinite(stats.loss) and stats.step_losses.shape == (T,)
    after = dict(engine.model.state_dict())
    after.update({f"fc.{k}": v for k, v in engine.fc.state_dict().items()})
    assert all(torch.equal(agg[k], after[k]) for k in agg)
    moved = [k for k, v in engine.ppo.policy.state_dict().items() if not torch.equal(v, pol[k])]
    assert moved
    for k, v in engine.ppo.policy_old.state_dict().items():
        assert torch.equal(v, engine.ppo.policy.state_dict()[k]), k
