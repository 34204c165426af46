"""K4's plain pair (``nt_xent_plain_fwd`` / ``nt_xent_plain_bwd``, the
kernels' interface with the ``(3, 2B)`` residual of row max, row sum and
norm) against the JAX package's ``_pallas_fwd`` / ``_pallas_bwd`` in
interpret mode, and against autograd of ``nt_xent_plain``: the loss to 1e-6
(absolute and relative), both views' grads to 1e-6 absolute and 1e-5
relative (the clamped zero row's gradient is ``dzn / 1e-8``, of order 1e5;
f32 sums in another order). Inputs are made with numpy from a seed. Also the
shapes ``_check`` takes, on the meta device: any B >= 1 and d, float32 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.ntxent_pallas as ntp
from murcl_tpu_torch.ops import ntxent as tnt


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ntp.pl, "pallas_call", interp)


def _views(b, d, zero_row):
    rng = np.random.default_rng(100 * b + d)
    zi = rng.normal(size=(b, d)).astype(np.float32)
    zj = rng.normal(size=(b, d)).astype(np.float32)
    if zero_row:
        zi[b // 2] = 0.0
    return zi, zj


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


CASES = ([(b, d, 0.07, 1 / 6, False) for b in (1, 4, 16) for d in (8, 32, 100)]
         + [(b, d, 1.0, 1.0, False) for b in (1, 4, 16) for d in (8, 32, 100)]
         + [(4, 32, 0.07, 1 / 6, True), (16, 100, 1.0, 1.0, True), (1, 8, 0.5, 1.0, True)])


@pytest.mark.parametrize("b,d,temp,g,zero_row", CASES)
def test_plain_pair_matches_pallas_and_autograd(b, d, temp, g, zero_row):
    zi, zj = _views(b, d, zero_row)
    want = ntp._pallas_fwd(jnp.asarray(zi), jnp.asarray(zj), temp)
    dwant = ntp._pallas_bwd(jnp.asarray(zi), jnp.asarray(zj), temp, g)

    ti, tj = torch.tensor(zi), torch.tensor(zj)
    loss, stats = tnt.nt_xent_plain_fwd(ti, tj, temp)
    assert stats.shape == (3, 2 * b) and stats.dtype == torch.float32
    _close(loss, want, 1e-6, 1e-6)
    grads = tnt.nt_xent_plain_bwd(ti, tj, temp, stats, torch.tensor(g))
    for got, w in zip(grads, dwant):
        _close(got, w, 1e-6, 1e-5)

    # the residual: the norm (clamped) and the masked row max and sum
    z = np.concatenate([zi, zj]).astype(np.float64)
    norms = np.maximum(np.sqrt((z * z).sum(1)), 1e-8)
    zn = z / norms[:, None]
    sim = np.where(np.eye(2 * b, dtype=bool), -1e9, zn @ zn.T / temp)
    row_max = sim.max(1)
    _close(stats[2], norms, 1e-6, 1e-6)
    _close(stats[0], row_max, 1e-6, 1e-5)
    _close(stats[1], np.exp(sim - row_max[:, None]).sum(1), 1e-6, 1e-5)

    # the stats-based backward against autograd of nt_xent_plain
    ai, aj = ti.clone().requires_grad_(True), tj.clone().requires_grad_(True)
    auto = torch.autograd.grad(tnt.nt_xent_plain(ai, aj, temp), (ai, aj), torch.tensor(g))
    _close(tnt.nt_xent_plain(ti, tj, temp), loss, 1e-6, 1e-6)
    for got, w in zip(grads, auto):
        _close(got, w, 1e-6, 1e-5)


@pytest.mark.parametrize("shape", [(256, 128), (128, 100), (1, 1), (3, 7)])
def test_check_takes_any_batch_and_width(shape):
    z = torch.empty(*shape, device="meta")
    tnt._check("nt_xent", z, z)


@pytest.mark.parametrize("zi,zj,match", [
    (torch.empty(128, 128, dtype=torch.bfloat16), torch.empty(128, 128, dtype=torch.bfloat16),
     "float32"),
    (torch.empty(128, 128), torch.empty(64, 128), "one shape"),
    (torch.empty(128, 128), torch.empty(128, 100), "one shape"),
    (torch.empty(2, 128, 128), torch.empty(2, 128, 128), "one shape"),
    (torch.empty(0, 128), torch.empty(0, 128), "empty batch"),
])
def test_check_refuses(zi, zj, match):
    with pytest.raises(ValueError, match=match):
        tnt._check("nt_xent", zi.to("meta"), zj.to("meta"))
