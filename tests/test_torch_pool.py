"""Port's attention pool without the trunk (K7's plain twins) vs the JAX package.

f32: against ``gated_attention_pool_xla`` through ``jax.vjp``: M/p/s to rtol
1e-5, ``dx`` and the 6 weight grads to rtol 1e-4, gated and ungated, with
masked bags. bf16: against the Pallas kernels (``_make_fwd_kernel`` /
``_make_bwd_kernel``) in interpret mode with XLA told not to keep excess
precision, whose rounding points the twins mirror; relative Frobenius error
1e-5 (f32 sums in another order), dropout 0 (the TPU PRNG has no CPU rule).
The port's gate dropout is deterministic per seed and keeps about 1 - rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops import attention as tat

B, N, F, D = 3, 24, 16, 8
NAMES = ["dx", "wa", "ba", "wb", "bb", "wc", "bc"]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    weights = [f(F, D, sc=0.4), f(D, sc=0.1), f(F, D, sc=0.4), f(D, sc=0.1), f(D, sc=0.4),
               np.float32(0.05)]
    x = f(B, N, F)
    mask = np.arange(N)[None, :] < np.array([24, 13, 5])[:, None]
    cots = [f(B, F), f(B, N), f(B, N)]
    return x, weights, mask, cots


def _jax_run(x, weights, mask, cots, gated, impl, dtype):
    def run(xx, ws):
        def fwd(xx, *w):
            return gap.gated_attention_pool(xx, *w, mask=jnp.asarray(mask), impl=impl,
                                            gated=gated)

        outs, vjp = jax.vjp(fwd, xx, *ws)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    xx = jnp.asarray(x, dtype)
    ws = [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(xx, ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    outs, grads = compiled(xx, ws)
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _torch_run(x, weights, mask, cots, gated, dtype):
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    w = [torch.tensor(v, requires_grad=True) for v in weights]
    outs = tat.gated_attention_pool(xt, *w, mask=torch.tensor(mask), gated=gated)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    grads = [xt.grad.float().numpy()] + [v.grad.numpy() for v in w]
    return [o.detach().numpy() for o in outs], grads


@pytest.mark.parametrize("gated", [True, False])
def test_plain_matches_xla_golden_f32(gated):
    x, weights, mask, cots = _inputs(0)
    want, gwant = _jax_run(x, weights, mask, cots, gated, "xla", jnp.float32)
    got, ggot = _torch_run(x, weights, mask, cots, gated, torch.float32)
    for name, w, g in zip("Mps", want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    for name, w, g in zip(NAMES, gwant, ggot):
        if not gated and name in ("wb", "bb"):
            assert not g.any(), name  # inert inputs of the ungated pool
            continue
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=1e-4, atol=1e-6, err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("gated", [True, False])
def test_plain_matches_pallas_interpret_bf16(interpret_pallas, gated):
    x, weights, mask, cots = _inputs(1)
    want, gwant = _jax_run(x, weights, mask, cots, gated, "pallas", jnp.bfloat16)
    got, ggot = _torch_run(x, weights, mask, cots, gated, torch.bfloat16)
    for name, w, g in zip(["M", "p", "s"] + NAMES, want + gwant, got + ggot):
        if not gated and name in ("wb", "bb"):
            continue
        assert _rel(g.reshape(np.shape(w)), w) <= 1e-5, name


def test_gate_dropout_deterministic_with_keep_rate():
    x, weights, mask, _ = _inputs(2)
    xt = torch.tensor(x)
    w = [torch.tensor(v) for v in weights]
    m = torch.tensor(mask)
    a = tat.gated_attention_pool(xt, *w, mask=m, dropout=0.25, seed=7)
    b = tat.gated_attention_pool(xt, *w, mask=m, dropout=0.25, seed=7)
    c = tat.gated_attention_pool(xt, *w, mask=m, dropout=0.25, seed=8)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[2], c[2])
    for stream in (1, 2):
        keep = tat._keep_bits(99, torch.arange(64), 128, 128, stream) >= \
            tat.dropout_threshold(0.25)
        assert abs(keep.float().mean().item() - 0.75) < 0.0075
