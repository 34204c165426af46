"""Port's conv policy encoder (``ActorCritic(policy_conv=True)``) and
cascaded-FC head (``FullLayer(fc_rnn=False)``) against the JAX modules.

- The conv encoder on a 4-D feature map ``(B, C, h, w)`` and on the
  engines' 2-D state ``(B, C)``, f32, to 1e-6 (JAX flattens the conv's
  output in ``(h, w, 32)`` order, torch in ``(32, h, w)``;
  ``engine/weights.py`` reorders the columns of the linear after it).
- The cascaded head: ``None`` logits at the restart, steps 2 to 5 through
  ``fc_2``..``fc_5`` to 1e-6, ``ValueError`` at step 6, ``zero_carry`` None.
- JAX -> port -> JAX round trips of both trees are exact, and a checkpoint
  the JAX package wrote with both loads into the port's modules whole.
- A MuRCL stage-2 ``train_step`` (rollout and one PPO update per view) with
  the conv policy against JAX's, with JAX's key schedule replayed as
  ``tests/test_torch_contrastive_stages.py`` replays it: step losses to rtol
  1e-5, the rollouts to rtol 1e-5 plus 1e-6, the policy after its updates
  to rtol 1e-5 plus 4e-6 of JAX's ``PPO.update`` on the same rollouts.
- JAX's engine cannot run the cascaded head (no logit at the restart step),
  and the port's drivers refuse it with a ``ValueError``; ``--policy_conv``
  runs both CLIs to a checkpoint that loads back.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.engine import BankArrays
from murcl_tpu.engine import ContrastiveEngine as JaxEngine
from murcl_tpu.engine import PretrainConfig as JaxConfig
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import ActorCritic as JaxActorCritic
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu.models.rlmil import Rollout as JaxRollout
from murcl_tpu.ops.mixup import mixup_factors as jax_mixup_factors
from murcl_tpu_torch import train_MuRCL, train_RLMIL
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.drivers import murcl, rlmil
from murcl_tpu_torch.engine.checkpoint import load_checkpoint, transfer_state
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.weights import (jax_from_params, jax_from_policy, params_from_jax,
                                            policy_from_jax)
from murcl_tpu_torch.models import ABMIL, CL, PPO, ActorCritic, FullLayer

DIM, K, B, T, FEAT, PROJ, HID, PHID, ALPHA, WIDTH = 16, 3, 4, 3, 24, 8, 32, 16, 0.9, 32
PPO_KW = dict(hidden_state_dim=PHID, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=2,
              action_size=K)


def _close(got, want, name, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def _assert_trees_equal(want, got):
    wl, wt = jax.tree_util.tree_flatten(want)
    gl, gt = jax.tree_util.tree_flatten(got)
    assert wt == gt
    for a, b in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("shape", [(5, 6, 3, 2), (5, 24)], ids=["map", "engine_state"])
def test_conv_encoder_matches_jax(shape):
    c = shape[1]
    state_dim = int(np.prod(shape[1:]))
    jmodel = JaxActorCritic(state_dim=state_dim, hidden_state_dim=PHID, action_size=K,
                            policy_conv=True, feature_dim=c)
    state = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    carry = np.random.default_rng(1).normal(size=(shape[0], PHID)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(state), jnp.asarray(carry))
    assert params["params"]["conv1x1"]["kernel"].shape == (c, 32)
    model = ActorCritic(state_dim, PHID, K, policy_conv=True, feature_dim=c)
    model.load_state_dict(policy_from_jax(params))
    assert model.state_encoder[0].weight.shape == (32, c, 1, 1)
    jmean, jvalue, jh = jmodel.apply(params, jnp.asarray(state), jnp.asarray(carry))
    mean, value, h = model(torch.tensor(state), torch.tensor(carry))
    for got, want, name in ((mean, jmean, "mean"), (value, jvalue, "value"), (h, jh, "h")):
        _close(got, want, name, rtol=1e-6, atol=1e-6)
    # the encoder module is the path forward runs, on a map as on the 2-D state
    fmap = torch.tensor(state).reshape(shape[0], c, *(shape[2:] or (1, 1)))
    assert torch.equal(model.state_encoder(fmap), model._encode(torch.tensor(state)))
    _assert_trees_equal(params, jax_from_policy(model.state_dict()))


def test_conv_encoder_refuses_a_state_that_is_not_whole_maps():
    with pytest.raises(ValueError, match="channels"):
        ActorCritic(30, policy_conv=True, feature_dim=8)


def test_cascaded_head_matches_jax():
    jfc = JaxFullLayer(feature_num=6, fc_rnn=False, class_num=PROJ)
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(3, 6)).astype(np.float32) for _ in range(6)]
    params = jfc.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), None)
    assert sorted(params["params"]) == ["fc_2", "fc_3", "fc_4", "fc_5"]
    fc = FullLayer(feature_num=6, fc_rnn=False, class_num=PROJ)
    fsd = params_from_jax(_abmil_tree(), params, arch="ABMIL")[1]
    assert sorted(fsd) == [f"fc_{t}.{w}" for t in range(2, 6) for w in ("bias", "weight")]
    fc.load_state_dict(fsd)
    assert fc.zero_carry(3) is None and jfc.zero_carry(3) is None
    jlogits, jcarry = jfc.apply(params, jnp.asarray(xs[0]), None)
    logits, carry = fc(torch.tensor(xs[0]))
    assert jlogits is None and logits is None
    for t in range(2, 6):
        jlogits, jcarry = jfc.apply(params, jnp.asarray(xs[t - 1]), jcarry)
        logits, carry = fc(torch.tensor(xs[t - 1]), carry)
        _close(logits, jlogits, f"step {t}", rtol=1e-6, atol=1e-6)
        _close(carry, jcarry, f"carry {t}", rtol=0, atol=0)
    with pytest.raises(ValueError, match="T<=5"):
        jfc.apply(params, jnp.asarray(xs[5]), jcarry)
    with pytest.raises(ValueError, match="T<=5"):
        fc(torch.tensor(xs[5]), carry)
    model_sd = params_from_jax(_abmil_tree(), params, arch="ABMIL")[0]
    _assert_trees_equal(params, jax_from_params(model_sd, fc.state_dict(), arch="ABMIL")[1])


def _abmil_tree():
    """A tiny aggregator tree to carry an fc tree through the converters."""
    return JaxABMIL(dim_in=DIM, L=WIDTH, D=8, dim_out=PROJ).init(jax.random.PRNGKey(1),
                                                                jnp.zeros((1, 4, DIM)))


def test_jax_checkpoint_with_both_options_loads_whole(tmp_path):
    from types import SimpleNamespace

    from murcl_tpu.engine.checkpoint import save_checkpoint

    jfc = JaxFullLayer(feature_num=WIDTH, fc_rnn=False, class_num=PROJ)
    params = {"model": _abmil_tree(),
              "fc": jfc.init(jax.random.PRNGKey(2), jnp.zeros((B, WIDTH)), None)}
    jppo = JaxPPO(state_dim=WIDTH, policy_conv=True, **PPO_KW)
    pstate = jppo.init(jax.random.PRNGKey(3), jnp.zeros((B, WIDTH)))
    save_checkpoint(tmp_path, 4, SimpleNamespace(params=params, opt_state=None), pstate,
                    filename="jax.pth.tar")
    ckpt = load_checkpoint(tmp_path / "jax.pth.tar")
    fc = FullLayer(feature_num=WIDTH, fc_rnn=False, class_num=PROJ)
    policy = ActorCritic(WIDTH, PHID, K, policy_conv=True)
    assert transfer_state(fc, ckpt["fc"]) == [] and transfer_state(policy, ckpt["policy"]) == []
    for module, want in ((fc, params_from_jax(params["model"], params["fc"], "ABMIL")[1]),
                         (policy, policy_from_jax(pstate.params))):
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k


def _stage2(seed=5):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(5):
        n = int(rng.integers(16, 48))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    ids = rng.integers(0, 5, size=B)
    kw = dict(dim_in=DIM, L=WIDTH, D=8, dim_out=PROJ, dropout=0.0)
    jfc = JaxFullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    jcfg = JaxConfig(arch="ABMIL", T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=2, alpha=ALPHA, temperature=0.5, batch_size=B, remat="none")
    jppo = JaxPPO(state_dim=WIDTH, policy_conv=True, **PPO_KW)
    jengine = JaxEngine(jcfg, JaxABMIL(**kw), jfc, ppo=jppo, tx=None)
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, WIDTH)))

    model, fc = ABMIL(**kw), FullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    msd, fsd = params_from_jax(params["model"], params["fc"], arch="ABMIL")
    model.load_state_dict(msd)
    fc.load_state_dict(fsd)
    ppo = PPO(WIDTH, policy_conv=True, **PPO_KW)
    ppo.load_policy(policy_from_jax(pstate.params))
    cfg = PretrainConfig(arch="ABMIL", T=T, feat_size=FEAT, num_clusters=K, train_stage=2,
                         alpha=ALPHA, temperature=0.5)
    engine = ContrastiveEngine(cfg, CL(model, projection_dim=PROJ), fc, None, ppo=ppo)
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, [0] * 5).device())
    return dict(jengine=jengine, params=params, pstate=pstate, engine=engine, jbank=jbank,
                bank=bank_from_arrays(feats, clusters, [0] * 5), ids=ids)


def _sequential_draws(rng):
    """JAX ``_rollout_sequential``'s draws from ``rng``, in the port's layout
    (the schedule of ``tests/test_torch_contrastive_stages.py``)."""
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


def test_stage2_step_with_the_conv_policy_matches_jax():
    e = _stage2()
    assert "conv1x1" in e["pstate"].params["params"]
    rng = jax.random.PRNGKey(13)
    jengine = e["jengine"]
    _, (jstats, jrollouts) = jengine._rollout_sequential(
        e["params"], e["pstate"].old_params, e["jbank"], jnp.asarray(e["ids"], jnp.int32),
        rng, False)
    _, new_pstate, jstep = jengine.train_step(jengine.init_state(e["params"]), e["pstate"],
                                              e["jbank"], jnp.asarray(e["ids"], jnp.int32),
                                              rng)
    engine, draws = e["engine"], _sequential_draws(rng)
    engine.model.eval()
    engine.fc.eval()
    with torch.no_grad():
        _, stats, rollouts = engine.rollout_sequential(e["bank"], torch.tensor(e["ids"]),
                                                       torch.Generator(), **draws)
    _close(stats.step_losses, jstats.step_losses, "step_losses", atol=0)
    for view, (got, want) in enumerate(zip(rollouts, jrollouts)):
        for name in ("states", "actions", "logprobs", "rewards"):
            _close(getattr(got, name), getattr(want, name), f"view {view} {name}")
    pstate = e["pstate"]
    for rollout in rollouts:  # JAX's update on the port's rollouts, view 0 then 1
        pstate, _ = jengine.ppo.update(pstate, JaxRollout(*(jnp.asarray(x.numpy())
                                                            for x in rollout)))
    stats = engine.train_step(e["bank"], torch.tensor(e["ids"]), torch.Generator(), **draws)
    _close(stats.step_losses, jstep.step_losses, "train_step losses", atol=0)
    want, moved = policy_from_jax(pstate.params), policy_from_jax(new_pstate.params)
    assert "state_encoder.0.weight" in want and "state_encoder.3.weight" in want
    for name, p in engine.ppo.policy.state_dict().items():
        _close(p, want[name], name, atol=4e-6)
        _close(p, moved[name], name, rtol=0, atol=4 * PPO_KW["lr"])
        assert torch.equal(engine.ppo.policy_old.state_dict()[name], p), name


def test_jax_engine_cannot_run_the_cascaded_head_and_the_drivers_refuse_it():
    kw = dict(dim_in=DIM, L=WIDTH, D=8, dim_out=PROJ, dropout=0.0)
    jfc = JaxFullLayer(feature_num=WIDTH, fc_rnn=False, class_num=PROJ)
    jcfg = JaxConfig(arch="ABMIL", T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=1, alpha=ALPHA, temperature=0.5, batch_size=B, remat="none")
    jengine = JaxEngine(jcfg, JaxABMIL(**kw), jfc,
                        tx=jax_make_optimizer("Adam", backbone_lr=1e-3, fc_lr=1e-3))
    params = jengine.init_params(jax.random.PRNGKey(0), jnp.zeros((B, FEAT, DIM)))
    e = _stage2()
    with pytest.raises((TypeError, AttributeError)):  # NT-Xent of the restart's None logits
        jengine.train_step(jengine.init_state(params), None, e["jbank"],
                           jnp.asarray(e["ids"], jnp.int32), jax.random.PRNGKey(1))
    for module in (murcl, rlmil):
        with pytest.raises(ValueError, match="logit at every step"):
            module.setup(module.default_args(fc_rnn=False))


def test_policy_conv_clis_save_a_checkpoint_that_loads_back(synthetic_dataset, tmp_path):
    ds = synthetic_dataset
    common = ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
              "--device", "cpu", "--feat_size", "16", "--T", "2", "--batch_size", "2",
              "--epochs", "1", "--ppo_epochs", "1", "--policy_conv"]
    base = ["--base_save_dir", str(tmp_path / "murcl"), "--data_repeat", "1"]
    train_MuRCL.main(common + base + ["--train_stage", "1"])
    out = train_MuRCL.main(common + base + ["--train_stage", "2"])
    murcl_best = Path(out["save_dir"]) / "model_best.pth.tar"
    rl = ["--base_save_dir", str(tmp_path / "rlmil"), "--save_model", "--train_method",
          "finetune", "--checkpoint_pretrained", str(murcl_best)]
    train_RLMIL.main(common + rl + ["--train_stage", "1"])
    out = train_RLMIL.main(common + rl + ["--train_stage", "2"])
    for path in (murcl_best, Path(out["save_dir"]) / "model_best.pth.tar"):
        policy = load_checkpoint(path)["policy"]
        assert policy["state_encoder.0.weight"].shape == (32, 512, 1, 1), path
        fresh = ActorCritic(512, 512, action_size=5, policy_conv=True)
        assert transfer_state(fresh, policy) == []
        assert all(torch.equal(v, policy[k]) for k, v in fresh.state_dict().items())
