"""Port's CLAM_SB instance-eval branch vs the JAX model's, same weights.

``CLAM_SB(...)(h, instance_eval=True, label=...)`` against JAX
``model.apply(params, h, label, True, mask=...)`` with weights moved by
``params_from_jax``, f32, dropout 0, with and without ``subtyping``: M and
``instance_loss`` to rtol 1e-5, every parameter's gradient of a random
projection of both to rtol 1e-4. Masked rows are zero rows, as in a padded
sub-bag, so ties among them pick identical trunk rows: the test compares
losses, not the indices top-k chose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu_torch.engine.optim import fill_missing_grads
from murcl_tpu_torch.engine.weights import params_from_jax
from murcl_tpu_torch.models import CLAM_SB

DIM, N, B, L1, L2, KS = 16, 20, 4, 32, 16, 3


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (L1, L2))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (L1, L2))


@pytest.mark.parametrize("n_classes,subtyping", [(2, True), (2, False), (3, True)])
def test_instance_eval_matches_jax(tiny_clam, n_classes, subtyping):
    rng = np.random.default_rng(n_classes + 2 * subtyping)
    mask = np.arange(N)[None, :] < np.array([20, 14, 9, 17])[:, None]
    h = rng.normal(size=(B, N, DIM)).astype(np.float32) * mask[..., None]
    label = np.array([0, 1, n_classes - 1, 1])
    cot_m = rng.normal(size=(B, L1)).astype(np.float32)
    cot_l = rng.normal(size=(B,)).astype(np.float32)
    kw = dict(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, k_sample=KS,
              n_classes=n_classes, subtyping=subtyping)

    jmodel = JaxCLAM(**kw)
    jh, jl, jm = jnp.asarray(h), jnp.asarray(label), jnp.asarray(mask)
    params = jmodel.init(jax.random.PRNGKey(0), jh, jl, True, mask=jm)

    def objective(p):
        m, aux = jmodel.apply(p, jh, jl, True, mask=jm)
        return jnp.sum(m * cot_m) + jnp.sum(aux["instance_loss"] * cot_l), (m, aux)

    (_, (jm_out, jaux)), jgrads = jax.value_and_grad(objective, has_aux=True)(params)

    model = CLAM_SB(**kw)
    model.load_state_dict(params_from_jax(params)[0])
    m, aux = model(torch.tensor(h), mask=torch.tensor(mask), instance_eval=True,
                   label=torch.tensor(label))
    (torch.sum(m * torch.tensor(cot_m)) + torch.sum(aux["instance_loss"] *
                                                    torch.tensor(cot_l))).backward()

    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux["instance_loss"].detach().numpy(),
                               np.asarray(jaux["instance_loss"]), rtol=1e-5)
    want = params_from_jax(jgrads)[0]
    fill_missing_grads(model.parameters())  # the dead bag head: as engine.optim.step
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
