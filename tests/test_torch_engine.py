"""Port's stage-1 batched rollout vs the JAX engine's ``_rollout_batched``.

Same weights (``params_from_jax``), same injected actions, and the mixup
draws rebuilt in the test from the JAX engine's own key splits
(``engine/contrastive.py:204,225``). In f32 with dropout 0: step losses to
rtol 1e-5, every live parameter's gradient to rtol 1e-4, and the parameters
after one Adam step to rtol 1e-5 plus 2e-6 absolute: Adam's step is about
lr = 1e-3 wherever |grad| >> eps, so a gradient that agrees only to 1e-4
relative moves the step by up to ~1e-7, and more where |grad| is near eps.

The dead parameters (``classifiers``, ``instance_classifiers``) get a zero
gradient in JAX, and optax's L2 weight decay still moves them. The port's
step (``engine.optim.step``) gives them a zero gradient first, so they
equal JAX's after the step like every other parameter.

Also here: linear evaluation's trainable set and the transfer of CLAM's
instance classifiers, each against the JAX package's rule.
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
from murcl_tpu.engine.checkpoint import transfer_params as jax_transfer_params
from murcl_tpu.engine.optim import linear_eval_frozen_paths
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.ops.mixup import mixup_factors as jax_mixup_factors
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.checkpoint import transfer_state
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.optim import freeze_for_linear_eval, make_optimizer, step
from murcl_tpu_torch.engine.weights import jax_from_params, params_from_jax
from murcl_tpu_torch.models import CL, CLAM_SB, FullLayer

DIM, K, B, T, FEAT, PROJ, HID = 16, 3, 4, 3, 24, 8, 32
L1, L2 = 32, 16


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (L1, L2))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (L1, L2))


def _data(seed):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(5):
        n = int(rng.integers(16, 48))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    ids = rng.integers(0, 5, size=B)
    actions = rng.random((T, 2, B, K)).astype(np.float32)
    return feats, clusters, ids, actions


def test_stage1_rollout_and_adam_step_match_jax(tiny_clam):
    feats, clusters, ids, actions = _data(0)
    labels = [0] * len(feats)
    lr = dict(backbone_lr=1e-3, fc_lr=5e-4, wdecay=1e-5)

    jmodel = JaxCLAM(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0,
                     n_classes=PROJ, subtyping=True)
    jfc = JaxFullLayer(feature_num=L1, hidden_state_dim=HID, class_num=PROJ)
    jcfg = JaxConfig(arch="CLAM_SB", T=T, feat_size=FEAT, num_clusters=K,
                     max_patches=256, alpha=0.9, temperature=0.5, batch_size=B,
                     remat="none")
    jengine = JaxEngine(jcfg, jmodel, jfc, tx=jax_make_optimizer("Adam", **lr))
    params = jengine.init_params(jax.random.PRNGKey(0), jnp.zeros((B, FEAT, DIM)))
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jengine._rollout_batched(p, jbank, jnp.asarray(ids, jnp.int32), rng,
                                        True, actions=jnp.asarray(actions))

    (_, (jstats, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _, _, r_mix, _ = jax.random.split(rng, 4)
    lams, perms = jax.vmap(lambda k: jax_mixup_factors(k, B, 0.9))(
        jax.random.split(r_mix, T * 2))

    model = CL(CLAM_SB(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0,
                       n_classes=PROJ, subtyping=True))
    fc = FullLayer(feature_num=L1, hidden_state_dim=HID, class_num=PROJ)
    msd, fsd = params_from_jax(params["model"], params["fc"])
    model.encoder.load_state_dict(msd)
    fc.load_state_dict(fsd)
    cfg = PretrainConfig(arch="CLAM_SB", T=T, feat_size=FEAT, num_clusters=K,
                         alpha=0.9, temperature=0.5)
    opt = make_optimizer(model, fc, "Adam", **lr)
    engine = ContrastiveEngine(cfg, model, fc, opt)
    total, stats = engine.rollout_batched(
        bank_from_arrays(feats, clusters, labels), torch.tensor(ids),
        torch.Generator(), actions=torch.tensor(actions),
        mix=(torch.tensor(np.asarray(lams)[..., 0]), torch.tensor(np.asarray(perms))))
    opt.zero_grad()
    total.backward()

    np.testing.assert_allclose(stats.step_losses.numpy(), np.asarray(jstats.step_losses),
                               rtol=1e-5)
    gm, gf = params_from_jax(jgrads["model"], jgrads["fc"])
    named = [(f"m:{k}", p, gm[k]) for k, p in model.encoder.named_parameters()]
    named += [(f"f:{k}", p, gf[k]) for k, p in fc.named_parameters()]
    for name, p, want in named:
        # a dead head has no gradient until step() gives it JAX's zeros
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)

    before = {name: p.detach().clone() for name, p, _ in named}
    step(opt)
    jstate = jengine.init_state(params)
    updates, _ = jengine.tx.update(jgrads, jstate.opt_state, params)
    new = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    nm, nf = params_from_jax(new["model"], new["fc"])
    for name, p, _ in named:
        want = (nm if name[0] == "m" else nf)[name[2:]]
        if name.endswith("attention_c.bias"):
            # softmax is shift-invariant: bc's true gradient is 0 and both
            # grads are rounding noise, so Adam moves it by about lr in
            # either direction
            assert abs(float(p.detach() - before[name])) <= 1.01 * lr["backbone_lr"]
        else:
            np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=1e-5,
                                       atol=2e-6, err_msg=name)


def _tree_marks(tree, frozen, path=()):
    """``tree`` with each leaf replaced by ones (trainable) or zeros (frozen)."""
    if hasattr(tree, "items"):
        return {k: _tree_marks(v, frozen, path + (k,)) for k, v in tree.items()}
    return np.full(np.shape(tree), 0.0 if frozen(path) else 1.0, np.float32)


@pytest.mark.parametrize("gate", [True, False])
def test_linear_eval_trains_what_jax_trains(tiny_clam, gate):
    """``freeze_for_linear_eval`` leaves trainable exactly the torch keys of
    the leaves JAX's ``linear_eval_frozen_paths`` does not freeze: CLAM's
    trunk (JAX ``fc``), ``classifiers`` and ``instance_classifiers``."""
    kw = dict(in_dim=DIM, gate=gate, size_arg="tiny", n_classes=2, subtyping=True)
    params = JaxCLAM(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, DIM)))
    marks, _ = params_from_jax(_tree_marks(params, linear_eval_frozen_paths("CLAM_SB")))
    want = {k for k, v in marks.items() if v.all()}
    assert not any(marks[k].any() for k in set(marks) - want)
    model = CLAM_SB(**kw)
    freeze_for_linear_eval(model, "CLAM_SB")
    got = {k for k, p in model.named_parameters() if p.requires_grad}
    assert got == want
    assert {k.rsplit(".", 1)[0] for k in got} == {
        "attention_net.0", "classifiers", "instance_classifiers.0", "instance_classifiers.1"}


def test_instance_classifiers_transfer_as_one_group(tiny_clam):
    """A 128-class MuRCL CLAM_SB into a 2-class one: the instance classifiers
    keep their fresh init as one group (JAX's stacked leaf), the rest loads
    where the shapes match; the same weights as ``transfer_params``."""
    kw = dict(in_dim=DIM, size_arg="tiny", subtyping=True)
    src = CL(CLAM_SB(n_classes=128, **kw))  # the MuRCL checkpoint's keys
    dst = CLAM_SB(n_classes=2, **kw)
    jfresh, _ = jax_from_params(dst.state_dict())
    jckpt, _ = jax_from_params(src.state_dict())
    fresh = {k: v.clone() for k, v in dst.state_dict().items()}

    skipped = transfer_state(dst, src.state_dict(), verbose=False)
    assert len(skipped) == 3 and skipped[0].startswith("instance_classifiers ("), skipped
    got = dst.state_dict()
    for k, v in got.items():
        head = k.startswith(("instance_classifiers.", "classifiers."))
        assert torch.equal(v, fresh[k] if head else src.state_dict()[f"encoder.{k}"]), k
    want, _ = params_from_jax(jax_transfer_params(jfresh, jckpt, verbose=False))
    assert want.keys() == got.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
