"""The port's data-parallel supervised (RLMIL) engine on the CPU: two gloo
ranks against the JAX ``SupervisedEngine(mesh=data_mesh(2))``.

As ``tests/test_torch_dp.py`` does for MuRCL: the ranks run
``tests/torch_dp_ranks.py`` (no ``jax`` in them), spawned once for every
case; this process builds the JAX side, the weights and each rank's draws,
rebuilt from JAX's per-shard keys ``fold_in(step_rng, i)``
(``_shard_actions_supervised``, ``tests/test_parallel.py:406-414``). Per rank
b = 3 slides, a padded global batch (its last two rows, on rank 1, repeat a
slide with ``valid`` false), feat_size 24, dim 16, K 3, T 3, f32, dropout 0,
Adam at the CLIs' 1e-4.

- Stage 1, CLAM_SB, ABMIL and DSMIL: loss and step losses within rtol 1e-5
  of the mesh engine's (global masked CE and extras), the final-step logits
  of the whole batch, gathered in global order, within rtol 1e-4 plus 1e-5
  (``tests/test_parallel.py:459-461``), every weight after one Adam step
  within rtol 1e-4 plus 1e-6, CLAM's score bias within the rate of its start
  (its true gradient is 0; ``tests/test_torch_engine.py``); both ranks'
  weights bitwise equal.
- Stage 3 (CLAM_SB): the same, with the policy unmoved.
- Stage 2 (CLAM_SB): step losses within rtol 1e-5, the aggregator untouched,
  and the policy's update on the rollout gathered in rank order (all its
  weights as one vector) within 2e-2 relative Frobenius of the update of
  JAX's ``PPO.update`` on that rollout (``tests/test_torch_dp.py`` says why
  not elementwise), each weight within 4 x the PPO rate of JAX's own mesh
  step; bitwise equal on both ranks.
- An evaluation of a 5-slide split, which 2 ranks do not divide, through
  ``drivers.rlmil._evaluate``: padded to 6 with its last slide masked out,
  as the JAX driver pads; its loss within rtol 1e-5 of the mesh engine's
  ``eval_step`` on the same padded batch, and its metrics within rtol 1e-5
  of ``get_metrics`` of JAX's logits of the 5 slides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
import torch_dp_ranks as ranks
from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.engine import BankArrays
from murcl_tpu.engine import RolloutConfig as JaxConfig
from murcl_tpu.engine import SupervisedEngine as JaxEngine
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.dsmil import MILNet as JaxMILNet
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu.models.rlmil import Rollout as JaxRollout
from murcl_tpu.parallel import data_mesh
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax
from murcl_tpu_torch.ops.metrics import get_metrics
from murcl_tpu_torch.parallel import launch

N, B_RANK = 2, 3
B = N * B_RANK
DIM, K, T, FEAT, HID, LR = ranks.DIM, ranks.K, ranks.T, ranks.FEAT, ranks.HID, ranks.LR
WIDTH = ranks.WIDTH
CASES = [("CLAM_SB", 1), ("ABMIL", 1), ("DSMIL", 1), ("CLAM_SB", 3), ("CLAM_SB", 2),
         ("CLAM_SB", "eval")]
N_EVAL = 5  # the evaluated split: not a multiple of N


def _data(seed, n_slides=8):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(n_slides):
        n = int(rng.integers(20, 60))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    labels = [int(v) for v in rng.permutation(n_slides) % 2]
    ids = rng.permutation(n_slides)[:B]
    ids[-2:] = ids[-3]  # a padded last batch: the tail repeats a slide
    return feats, clusters, labels, ids, np.arange(B) < B - 2


def _jax_model(arch):
    if arch == "ABMIL":
        return JaxABMIL(dim_in=DIM, L=WIDTH, D=16, dim_out=2), WIDTH
    if arch == "DSMIL":
        return JaxMILNet(dim_feat=DIM, num_classes=2), DIM
    return JaxCLAM(n_classes=2, k_sample=4, **ranks.CLAM_KW), WIDTH


def _draws(step_rng, stage, b):
    """Each shard's draws (``engine/supervised.py:296-298`` for stage 1;
    ``:398-399,416`` and the policy's noise for stages 2 and 3)."""
    out = []
    for i in range(N):
        r = jax.random.fold_in(step_rng, i)
        if stage == 1:
            _, r_act, _ = jax.random.split(r, 3)
            out.append({"actions": torch.tensor(np.asarray(
                jax.random.uniform(r_act, (T, b, K))))})
            continue
        rest, r_act0, _ = jax.random.split(r, 3)
        noise = [np.asarray(jax.random.normal(jax.random.split(rt)[0], (b, K)))
                 for rt in jax.random.split(rest, T - 1)]
        out.append({"actions0": torch.tensor(np.asarray(jax.random.uniform(r_act0, (b, K)))),
                    "noise": torch.tensor(np.stack(noise))})
    return out


def _jax_side(arch, stage, seed):
    evaluate = stage == "eval"
    stage = 1 if evaluate else stage
    feats, clusters, labels, ids, valid = _data(seed)
    if evaluate:  # the split itself, padded to a multiple of N with its last slide
        feats, clusters, labels = feats[:N_EVAL], clusters[:N_EVAL], labels[:N_EVAL]
        ids = np.concatenate([np.arange(N_EVAL), np.full(-N_EVAL % N, N_EVAL - 1)])
        valid = np.arange(ids.size) < N_EVAL
    jmodel, width = _jax_model(arch)
    jcfg = JaxConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=stage, num_classes=2, bag_weight=0.7, remat="none")
    jppo = JaxPPO(state_dim=width, **ranks.PPO_KW) if stage != 1 else None
    tx = jax_make_optimizer("Adam", backbone_lr=LR, fc_lr=LR) if stage != 2 else None
    jengine = JaxEngine(jcfg, jmodel,
                        JaxFullLayer(feature_num=width, hidden_state_dim=HID, class_num=2),
                        ppo=jppo, tx=tx, mesh=data_mesh(N))
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)),
                                 jnp.zeros((B,), jnp.int32))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, width))) if jppo else None
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    step_rng = jax.random.PRNGKey(200 + seed)
    args = (jengine.init_state(params), pstate, jbank, jnp.asarray(ids, jnp.int32),
            jnp.asarray(np.asarray(labels)[ids], jnp.int32), step_rng)
    want = {"jengine": jengine, "pstate": pstate}
    if evaluate:
        want["stats"] = jengine.eval_step(*args, valid=jnp.asarray(valid))
    else:
        agg, want["new_pstate"], want["stats"] = jengine.train_step(*args,
                                                                     valid=jnp.asarray(valid))
        want["params"] = agg.params
    msd, fsd = params_from_jax(params["model"], params["fc"], arch=arch)
    case = {"kind": "supervised", "arch": arch, "stage": stage, "eval": evaluate,
            "feats": feats, "clusters": clusters, "labels": labels, "ids": ids,
            "valid": valid, "model": msd, "fc": fsd,
            "policy": policy_from_jax(pstate.params) if pstate else None,
            "draws": _draws(step_rng, stage, ids.size // N)}
    return case, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clam.SIZE_DICT, "tiny", (WIDTH, 16))
        sides = {key: _jax_side(*key, seed=i) for i, key in enumerate(CASES)}
    cases = [sides[key][0] for key in CASES]
    got = launch(N, ranks.run_cases, cases, run_dir=tmp_path_factory.mktemp("dp"))
    return {key: (sides[key][0], sides[key][1], [got[r][0][i] for r in range(N)])
            for i, key in enumerate(CASES)}


def _assert_ranks_equal(outs):
    for part in ("model", "fc", "policy", "policy_old"):
        if part in outs[0]:
            for k, v in outs[0][part].items():
                assert torch.equal(v, outs[1][part][k]), (part, k)


@pytest.mark.parametrize("arch,stage", [("CLAM_SB", 1), ("ABMIL", 1), ("DSMIL", 1),
                                        ("CLAM_SB", 3)])
def test_training_step_matches_the_mesh_engine(runs, arch, stage):
    case, want, outs = runs[arch, stage]
    _assert_ranks_equal(outs)
    stats = want["stats"]
    for out in outs:
        np.testing.assert_allclose(float(out["loss"]), float(stats.loss), rtol=1e-5)
        np.testing.assert_allclose(out["step_losses"].numpy(), np.asarray(stats.step_losses),
                                   rtol=1e-5)
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(stats.logits), rtol=1e-4,
                                   atol=1e-5)
    want_m, want_f = params_from_jax(want["params"]["model"], want["params"]["fc"], arch=arch)
    for part, ref in (("model", want_m), ("fc", want_f)):
        for name, v in outs[0][part].items():
            if name.endswith("attention_c.bias"):
                assert float((v - case["model"][name]).abs().max()) <= 1.01 * LR
                continue
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{part}.{name}")
    if stage == 3:
        for k, v in case["policy"].items():
            assert torch.equal(outs[0]["policy"][k], v), k


def test_stage2_ppo_updates_on_the_gathered_rollout(runs):
    case, want, outs = runs["CLAM_SB", 2]
    _assert_ranks_equal(outs)
    np.testing.assert_allclose(outs[0]["step_losses"].numpy(),
                               np.asarray(want["stats"].step_losses), rtol=1e-5)
    for part in ("model", "fc"):
        for k, v in case[part].items():
            assert torch.equal(outs[0][part][k], v), (part, k)
    gathered = [torch.cat([o["rollouts"][0][f] for o in outs], dim=1) for f in range(4)]
    assert gathered[0].shape[1] == B
    pstate, _ = want["jengine"].ppo.update(
        want["pstate"], JaxRollout(*(jnp.asarray(x.numpy()) for x in gathered)))
    assert ranks.update_err(outs[0]["policy"], case["policy"],
                            policy_from_jax(pstate.params)) <= 2e-2
    moved = policy_from_jax(want["new_pstate"].params)
    for name, v in outs[0]["policy"].items():
        assert torch.equal(outs[0]["policy_old"][name], v), name
        # JAX's own mesh step moved the same weights, by as much
        np.testing.assert_allclose(v.numpy(), moved[name].numpy(), rtol=0,
                                   atol=4 * ranks.PPO_KW["lr"], err_msg=name)


def test_evaluation_pads_a_split_the_ranks_do_not_divide(runs):
    case, want, outs = runs["CLAM_SB", "eval"]
    stats = want["stats"]
    logits = np.asarray(stats.logits)[:N_EVAL]
    for out in outs:
        np.testing.assert_allclose(out["loss"], float(stats.step_losses[-1]), rtol=1e-5)
        np.testing.assert_allclose(out["metrics"], get_metrics(logits, np.asarray(case["labels"])),
                                   rtol=1e-5)
