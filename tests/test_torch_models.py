"""Port's CLAM_SB + FullLayer vs the JAX modules on the same weights.

Forward to 1e-5 (f32, dropout 0) with weights moved by ``params_from_jax``;
the port's ``state_dict`` keys equal ``murcl_tpu.engine.torch_import``'s
``export_model_state`` (CLAM) and its Full_layer map; ``params_from_jax``
and ``jax_from_params`` round-trip exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu.engine.torch_import import FULL_LAYER_MAP, export_model_state, flax_to_torch
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu_torch.engine.weights import jax_from_params, params_from_jax
from murcl_tpu_torch.models import CL, CLAM_SB, ActorCritic, FullLayer, build_aggregator

DIM, N, B, PROJ, HID = 16, 12, 3, 8, 32


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (32, 16))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (32, 16))


def _jax_params(seed=0):
    jm = JaxCLAM(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, n_classes=PROJ,
                 subtyping=True)
    jf = JaxFullLayer(feature_num=32, hidden_state_dim=HID, class_num=PROJ)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mp = jm.init(k1, jnp.zeros((B, N, DIM)))
    fp = jf.init(k2, jnp.zeros((B, 32)), None)
    return jm, jf, mp, fp


def _torch_modules(mp, fp):
    model = CLAM_SB(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, n_classes=PROJ,
                    subtyping=True)
    fc = FullLayer(feature_num=32, hidden_state_dim=HID, class_num=PROJ)
    msd, fsd = params_from_jax(mp, fp)
    model.load_state_dict(msd)
    fc.load_state_dict(fsd)
    return model.eval(), fc


def test_forward_matches_jax(tiny_clam):
    jm, jf, mp, fp = _jax_params()
    model, fc = _torch_modules(mp, fp)
    rng = np.random.default_rng(0)
    h = rng.normal(size=(B, N, DIM)).astype(np.float32)
    carry = rng.normal(size=(B, HID)).astype(np.float32)
    jM, jaux = jm.apply(mp, jnp.asarray(h))
    jlog, jcarry = jf.apply(fp, jM, jnp.asarray(carry))
    jlog0, _ = jf.apply(fp, jM, None)
    with torch.no_grad():
        M, aux = model(torch.tensor(h))
        log, c = fc(M, torch.tensor(carry))
        log0, _ = fc(M)
    pairs = [(M, jM), (aux["attention"], jaux["attention"]), (aux["logits"], jaux["logits"]),
             (log, jlog), (c, jcarry), (log0, jlog0)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_state_dict_keys_match_reference_layout(tiny_clam):
    _, _, mp, fp = _jax_params()
    model, fc = _torch_modules(mp, fp)
    assert set(model.state_dict()) == set(export_model_state(mp, "CLAM_SB"))
    assert set(fc.state_dict()) == set(flax_to_torch(fp, FULL_LAYER_MAP))
    assert all(k.startswith("encoder.") for k in CL(model).state_dict())
    for k, v in export_model_state(mp, "CLAM_SB").items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v)


def test_params_round_trip(tiny_clam):
    _, _, mp, fp = _jax_params(1)
    msd, fsd = params_from_jax(mp, fp)
    back_m, back_f = jax_from_params({f"encoder.{k}": v for k, v in msd.items()}, fsd)
    for want, got in ((mp, back_m), (fp, back_f)):
        wl, wt = jax.tree_util.tree_flatten(want)
        gl, gt = jax.tree_util.tree_flatten(got)
        assert wt == gt
        for a, b in zip(wl, gl):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_unported_options_raise():
    # ungated CLAM is ported (tests/test_torch_fused_modes.py); DSMIL is not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_aggregator("DSMIL", dim_in=DIM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FullLayer(32, fc_rnn=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ActorCritic(32, policy_conv=True)
    # the instance branch is ported (tests/test_torch_clam_instance.py); it needs labels
    with pytest.raises(ValueError, match="labels"):
        CLAM_SB(in_dim=DIM)(torch.zeros(1, 4, DIM), instance_eval=True)
