"""Port's MuRCL engine vs the JAX ``ContrastiveEngine``: ABMIL stage 1, and
stages 2 and 3 for CLAM_SB and ABMIL.

Same weights (``params_from_jax``, ``policy_from_jax``), f32, dropout 0. The
JAX rollouts draw inside themselves, so the test replays their key schedule
and injects the draws into the port:

- stage 1 (``_rollout_batched``): actions injected, the mixup draws of the
  ``T*2`` (step, view) groups from the split at ``engine/contrastive.py:204,225``;
- stages 2/3 (``_rollout_sequential``): the t=0 actions and mixup draws from
  the splits at ``:370`` and ``:335``, then per step the split at ``:414``
  and ``:386``, the policy noise of ``act`` (``murcl_tpu/models/rlmil.py:179``)
  and each view's ``mixup_factors``.

Step losses to rtol 1e-5; rewards, rollout states, actions and log-probs to
rtol 1e-5 plus 1e-6 absolute (the rewards are differences of similarities);
every live parameter's gradient to rtol 1e-4 (dead heads: a zero gradient
in JAX, none in the port). A whole stage-2 ``train_step`` (one PPO update
per view, view 0 first) leaves the aggregator untouched and the policy
within rtol 1e-5 plus 4e-6 absolute of JAX's ``PPO.update`` applied twice,
view 0 then view 1, to the rollouts the port's engine records (each update
agrees to 2e-6 where an Adam step meets |grad| near eps,
``tests/test_torch_ppo.py``). JAX's own rollouts are not the input there:
each reward is a difference of two cosine similarities near 1, so its f32
rounding (1e-7 absolute, within the tolerance above) becomes about 1e-4 of
the normalised returns, and Adam turns that into up to 4e-4 on weights
whose gradient sits near eps.
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
from murcl_tpu.engine import ContrastiveEngine as JaxEngine
from murcl_tpu.engine import PretrainConfig as JaxConfig
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu.models.rlmil import Rollout as JaxRollout
from murcl_tpu.ops.mixup import mixup_factors as jax_mixup_factors
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.optim import fill_missing_grads, make_optimizer
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax
from murcl_tpu_torch.models import ABMIL, CL, CLAM_SB, PPO, FullLayer

DIM, K, B, T, FEAT, PROJ, HID, PHID, ALPHA = 16, 3, 4, 3, 24, 8, 32, 16, 0.9
WIDTH = 32  # ABMIL's L and CLAM's L1: the embedding the head and policy take
PPO_KW = dict(hidden_state_dim=PHID, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=2,
              action_size=K)


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (WIDTH, 16))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (WIDTH, 16))


def _models(arch):
    if arch == "ABMIL":
        kw = dict(dim_in=DIM, L=WIDTH, D=8, dim_out=PROJ, dropout=0.0)
        return JaxABMIL(**kw), ABMIL(**kw)
    kw = dict(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, n_classes=PROJ,
              subtyping=True)
    return JaxCLAM(**kw), CLAM_SB(**kw)


def _setup(arch, stage, seed=0):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(5):
        n = int(rng.integers(16, 48))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    ids = rng.integers(0, 5, size=B)
    labels = [0] * len(feats)

    jmodel, model = _models(arch)
    jfc = JaxFullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    jcfg = JaxConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=stage, alpha=ALPHA, temperature=0.5, batch_size=B,
                     remat="none")
    jppo = JaxPPO(state_dim=WIDTH, **PPO_KW) if stage != 1 else None
    tx = jax_make_optimizer("Adam", backbone_lr=1e-3, fc_lr=1e-3) if stage != 2 else None
    jengine = JaxEngine(jcfg, jmodel, jfc, ppo=jppo, tx=tx)
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, WIDTH))) if jppo else None

    fc = FullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    msd, fsd = params_from_jax(params["model"], params["fc"], arch=arch)
    model.load_state_dict(msd)
    fc.load_state_dict(fsd)
    ppo = None
    if stage != 1:
        ppo = PPO(WIDTH, **PPO_KW)
        ppo.load_policy(policy_from_jax(pstate.params))
    cl = CL(model, projection_dim=PROJ)
    opt = make_optimizer(cl, fc, "Adam", backbone_lr=1e-3, fc_lr=1e-3) if stage != 2 else None
    cfg = PretrainConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, train_stage=stage,
                         alpha=ALPHA, temperature=0.5)
    engine = ContrastiveEngine(cfg, cl, fc, opt, ppo=ppo)
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    return dict(jengine=jengine, params=params, pstate=pstate, engine=engine, jbank=jbank,
                bank=bank_from_arrays(feats, clusters, labels), ids=ids)


def _sequential_draws(rng):
    """The draws of JAX ``_rollout_sequential`` from ``rng``, port layout:
    ``actions0 (2, B, K)``, ``noise (T-1, 2, B, K)``, ``mix (lams, perms)``
    each ``(T, 2, B)``."""
    rest, ra0, ra1, rv0 = jax.random.split(rng, 4)
    actions0 = np.stack([np.asarray(jax.random.uniform(r, (B, K))) for r in (ra0, ra1)])
    step_keys, noise = [rv0], []
    for rt in jax.random.split(rest, T - 1):
        r_aa, r_ab, r_va, _ = jax.random.split(rt, 4)
        noise.append([np.asarray(jax.random.normal(r, (B, K))) for r in (r_aa, r_ab)])
        step_keys.append(r_va)
    lams, perms = [], []
    for key in step_keys:
        draws = [jax_mixup_factors(k, B, ALPHA) for k in jax.random.split(key, 3)[:2]]
        lams.append([np.asarray(lam)[:, 0] for lam, _ in draws])
        perms.append([np.asarray(perm) for _, perm in draws])
    return dict(actions0=torch.tensor(actions0), noise=torch.tensor(np.asarray(noise)),
                mix=(torch.tensor(np.asarray(lams)), torch.tensor(np.asarray(perms))))


def _compare_grads(engine, jgrads, arch):
    gm, gf = params_from_jax(jgrads["model"], jgrads["fc"], arch=arch)
    named = [(k, p, gm[k]) for k, p in engine.model.encoder.named_parameters()]
    named += [(f"fc:{k}", p, gf[k]) for k, p in engine.fc.named_parameters()]
    live = sum(p.grad is not None for _, p, _ in named)
    # dead heads (classifiers, instance_classifiers, ABMIL's fc): as engine.optim.step
    fill_missing_grads(p for _, p, _ in named)
    for name, p, want in named:
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)
    assert live >= 8


def _close(got, want, name, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def test_abmil_stage1_batched_rollout_matches_jax():
    e = _setup("ABMIL", 1)
    actions = np.random.default_rng(1).random((T, 2, B, K)).astype(np.float32)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        return e["jengine"]._rollout_batched(p, e["jbank"], jnp.asarray(e["ids"], jnp.int32),
                                             rng, True, actions=jnp.asarray(actions))

    (_, (jstats, _)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(e["params"])
    _, _, r_mix, _ = jax.random.split(rng, 4)
    lams, perms = jax.vmap(lambda k: jax_mixup_factors(k, B, ALPHA))(
        jax.random.split(r_mix, T * 2))
    engine = e["engine"]
    total, stats = engine.rollout_batched(
        e["bank"], torch.tensor(e["ids"]), torch.Generator(), actions=torch.tensor(actions),
        mix=(torch.tensor(np.asarray(lams)[..., 0]), torch.tensor(np.asarray(perms))))
    total.backward()
    _close(stats.step_losses, jstats.step_losses, "step_losses", atol=0)
    _close(stats.rewards, jstats.rewards, "rewards")
    _compare_grads(engine, jgrads, "ABMIL")


@pytest.mark.parametrize("arch", ["CLAM_SB", "ABMIL"])
@pytest.mark.parametrize("stage", [2, 3])
def test_sequential_rollout_matches_jax(tiny_clam, arch, stage):
    e = _setup(arch, stage, seed=stage)
    rng = jax.random.PRNGKey(11)
    train = stage == 3

    def loss_fn(p):
        return e["jengine"]._rollout_sequential(p, e["pstate"].old_params, e["jbank"],
                                                jnp.asarray(e["ids"], jnp.int32), rng, train)

    if train:
        (_, (jstats, jrollouts)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            e["params"])
    else:
        _, (jstats, jrollouts) = loss_fn(e["params"])
    engine = e["engine"]
    engine.model.train(train)
    engine.fc.train(train)
    with torch.set_grad_enabled(train):
        total, stats, rollouts = engine.rollout_sequential(
            e["bank"], torch.tensor(e["ids"]), torch.Generator(), **_sequential_draws(rng))
    _close(stats.step_losses, jstats.step_losses, "step_losses", atol=0)
    _close(stats.rewards, jstats.rewards, "rewards")
    for view, (got, want) in enumerate(zip(rollouts, jrollouts)):
        for name in ("states", "actions", "logprobs", "rewards"):
            _close(getattr(got, name), getattr(want, name), f"view {view} {name}")
    if train:
        total.backward()
        _compare_grads(engine, jgrads, arch)


@pytest.mark.parametrize("arch", ["CLAM_SB", "ABMIL"])
def test_stage2_train_step_matches_jax(tiny_clam, arch):
    e = _setup(arch, 2, seed=5)
    rng = jax.random.PRNGKey(13)
    jengine = e["jengine"]
    agg_state = jengine.init_state(e["params"])
    _, new_pstate, jstats = jengine.train_step(agg_state, e["pstate"], e["jbank"],
                                               jnp.asarray(e["ids"], jnp.int32), rng)
    engine = e["engine"]
    draws = _sequential_draws(rng)
    engine.model.eval()
    engine.fc.eval()
    with torch.no_grad():  # the rollouts train_step records: same draws, same policy_old
        _, _, rollouts = engine.rollout_sequential(e["bank"], torch.tensor(e["ids"]),
                                                   torch.Generator(), **draws)
    pstate = e["pstate"]
    for rollout in rollouts:
        pstate, _ = jengine.ppo.update(pstate, JaxRollout(*(jnp.asarray(x.numpy())
                                                            for x in rollout)))
    agg = {k: v.clone() for k, v in engine.model.state_dict().items()}
    agg.update({f"fc.{k}": v.clone() for k, v in engine.fc.state_dict().items()})
    stats = engine.train_step(e["bank"], torch.tensor(e["ids"]), torch.Generator(), **draws)
    _close(stats.step_losses, jstats.step_losses, "step_losses", atol=0)
    want = policy_from_jax(pstate.params)
    moved = policy_from_jax(new_pstate.params)
    for name, p in engine.ppo.policy.state_dict().items():
        _close(p, want[name], name, atol=4e-6)
        assert torch.equal(engine.ppo.policy_old.state_dict()[name], p), name
        # JAX's whole train_step moved the same weights, by as much
        _close(p, moved[name], name, rtol=0, atol=4 * PPO_KW["lr"])
    after = dict(engine.model.state_dict())
    after.update({f"fc.{k}": v for k, v in engine.fc.state_dict().items()})
    assert all(torch.equal(agg[k], after[k]) for k in agg)


def test_engine_guards(tiny_clam):
    model = CL(CLAM_SB(in_dim=DIM, size_arg="tiny", n_classes=PROJ))
    fc = FullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    opt = make_optimizer(model, fc, "Adam")
    with pytest.raises(ValueError, match="PPO"):
        ContrastiveEngine(PretrainConfig(arch="CLAM_SB", train_stage=3), model, fc, opt)
    with pytest.raises(ValueError, match="optimizer"):
        ContrastiveEngine(PretrainConfig(arch="CLAM_SB"), model, fc)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContrastiveEngine(PretrainConfig(arch="DSMIL"), model, fc, opt)
