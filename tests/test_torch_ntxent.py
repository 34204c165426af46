"""Port's NT-Xent (plain path) vs the JAX package's ``nt_xent`` and the
``nt_xent_pallas`` kernel in interpret mode: loss and both views' grads to
1e-6, including a zero row (the norm clamp and its gradient branch). The
clamped row's gradient is ``dzn / 1e-8``, of order 1e5, so grads are also
held to a relative 1e-5 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.ntxent_pallas as ntp
from murcl_tpu.ops.ntxent import nt_xent as jax_nt_xent
from murcl_tpu_torch.ops.ntxent import nt_xent


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ntp.pl, "pallas_call", interp)


# the XLA nt_xent differentiates jnp.linalg.norm, whose gradient at a zero
# row is NaN; the kernel's analytic backward (and the port) take the clamp
# branch, so the zero row is held against the kernel only
@pytest.mark.parametrize("jax_fn,b,d,temp,zero_row", [
    (jax_nt_xent, 4, 8, 0.5, False),
    (jax_nt_xent, 16, 32, 1.0, False),
    (ntp.nt_xent_pallas, 4, 8, 0.5, False),
    (ntp.nt_xent_pallas, 16, 32, 1.0, True),
], ids=["xla-small", "xla", "pallas-small", "pallas-zero-row"])
def test_loss_and_grads_match_jax(jax_fn, b, d, temp, zero_row):
    rng = np.random.default_rng(b)
    zi = rng.normal(size=(b, d)).astype(np.float32)
    zj = rng.normal(size=(b, d)).astype(np.float32)
    if zero_row:
        zi[1] = 0.0
    want, gwant = jax.value_and_grad(lambda a, c: jax_fn(a, c, temp), argnums=(0, 1))(
        jnp.asarray(zi), jnp.asarray(zj))
    ti = torch.tensor(zi, requires_grad=True)
    tj = torch.tensor(zj, requires_grad=True)
    loss = nt_xent(ti, tj, temp)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-6, rtol=1e-6)
    for g, w in zip((ti.grad, tj.grad), gwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)
