"""Port's DSMIL ``MILNet`` against ``murcl_tpu.models.dsmil.MILNet``.

The same weights (moved by ``params_from_jax``) and inputs (numpy seeds)
through both, with and without a mask of padded rows: instance logits, the
bag tensor, the attention and the dead conv head's logits (computed only on
request) within 1e-6 in f32 and 2e-2 (relative Frobenius) in bf16. The weights round-trip through
``params_from_jax`` / ``jax_from_params`` and match the JAX package's own
import of a reference-layout state dict (``import_model_state``, ``DSMIL_MAP``
plus ``fcc``). ``build_aggregator("DSMIL")`` gives the JAX package's
module and width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.engine.torch_import import import_model_state
from murcl_tpu.models.dsmil import MILNet as JaxMILNet
from murcl_tpu_torch.engine.optim import freeze_for_linear_eval, make_optimizer
from murcl_tpu_torch.engine.weights import jax_from_params, jax_leaf_path, params_from_jax
from murcl_tpu_torch.models import FullLayer, MILNet, build_aggregator

DIM, C, B, N = 64, 3, 3, 40


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, DIM)).astype(np.float32)
    mask = None
    if masked:
        lengths = np.array([N, 25, 7])
        mask = np.arange(N)[None, :] < lengths[:, None]
    return x, mask


def _pair(seed=0):
    jmodel = JaxMILNet(dim_feat=DIM, num_classes=C)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, DIM)))
    model = MILNet(dim_feat=DIM, num_classes=C)
    model.load_state_dict(params_from_jax(params, arch="DSMIL")[0])
    return jmodel, params, model.eval()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_milnet_matches_jax(masked, dtype):
    jmodel, params, model = _pair(seed=1)
    x, mask = _inputs(2, masked)
    jx = jnp.asarray(x).astype(dtype)
    jinst, jbag, jaux = jmodel.apply(params, jx, None if mask is None else jnp.asarray(mask))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    with torch.no_grad():
        inst, bag, aux = model(tx, None if mask is None else torch.tensor(mask),
                               with_conv=True)
    assert inst.dtype == bag.dtype == tx.dtype
    assert inst.shape == (B, N, C) and bag.shape == (B, C, DIM)
    pairs = {"inst": (inst, jinst), "bag": (bag, jbag),
             "attention": (aux["attention"], jaux["attention"]),
             "conv_logits": (aux["conv_logits"], jaux["conv_logits"])}
    for name, (got, want) in pairs.items():
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            assert _rel(got, want) <= 2e-2, (name, _rel(got, want))
    if masked:  # padded rows take no attention
        assert float(aux["attention"][2, 7:].abs().max()) == 0.0


def test_milnet_conv_head_only_on_request():
    """The dead conv head is left out of the forward unless asked for; the
    rest of the output does not depend on it."""
    _, _, model = _pair(seed=2)
    x = torch.tensor(_inputs(5, True)[0])
    with torch.no_grad():
        inst, bag, aux = model(x)
        inst_c, bag_c, aux_c = model(x, with_conv=True)
    assert set(aux) == {"attention"} and set(aux_c) == {"attention", "conv_logits"}
    assert torch.equal(inst, inst_c) and torch.equal(bag, bag_c)
    assert aux_c["conv_logits"].shape == (B, C)


def test_milnet_weights_round_trip_and_match_reference_import():
    _, params, model = _pair(seed=3)
    sd = model.state_dict()
    assert set(sd) == {"i_classifier.fc.0.weight", "i_classifier.fc.0.bias",
                       "b_classifier.q.weight", "b_classifier.q.bias",
                       "b_classifier.v.1.weight", "b_classifier.v.1.bias",
                       "b_classifier.fcc.weight", "b_classifier.fcc.bias"}
    assert sd["b_classifier.fcc.weight"].shape == (C, C, DIM)
    back, _ = jax_from_params(sd, arch="DSMIL")
    imported = import_model_state({k: v.numpy() for k, v in sd.items()}, "DSMIL")
    for tree in (back, imported):
        want, wdef = jax.tree_util.tree_flatten(params)
        got, gdef = jax.tree_util.tree_flatten(tree)
        assert wdef == gdef
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for key in sd:  # every key names its JAX leaf
        leaf = params["params"]
        for name in jax_leaf_path(key, "DSMIL"):
            leaf = leaf[name]
        assert np.asarray(leaf).size == sd[key].numel(), key


def test_build_aggregator_dsmil_and_linear_eval_freezes_it():
    model, width = build_aggregator("DSMIL", dim_in=DIM, num_classes=C,
                                    arch_setting={"dropout_v": 0.25})
    assert isinstance(model, MILNet) and width == DIM and model.dropout_v == 0.25
    freeze_for_linear_eval(model, "DSMIL")
    assert not any(p.requires_grad for p in model.parameters())
    opt = make_optimizer(model, FullLayer(DIM, 8, class_num=C), "Adam")
    assert [g["name"] for g in opt.param_groups] == ["fc"]


def test_milnet_dropout_draws_from_generator():
    model = MILNet(dim_feat=DIM, num_classes=C, dropout_v=0.5).train()
    x = torch.tensor(_inputs(4, False)[0])
    a = model(x, generator=torch.Generator().manual_seed(0))[1]
    b = model(x, generator=torch.Generator().manual_seed(0))[1]
    c = model(x, generator=torch.Generator().manual_seed(1))[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert not torch.equal(model.eval()(x)[1], a)
