"""Port's fused trunk + attention pool (plain path) vs the JAX package.

f32: against ``fused_trunk_attention_pool_xla`` (M/p/s rtol 1e-5, the 8
weight grads rtol 1e-4). bf16: against the Pallas kernel in interpret mode,
whose rounding points the plain version mirrors. XLA on the CPU is told
not to keep excess precision between bf16 ops (it rounds after each one, as
the TPU does); then the two agree to a relative Frobenius error of 1e-5
(f32 sums taken in another order). Dropout stays 0 against
JAX (the TPU PRNG has no CPU rule); the port's own dropout hash is checked
for determinism, keep rate and agreement with its 32-bit definition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops import attention as tat

B, N, FIN, L1, D = 4, 16, 8, 16, 8
NAMES = ["wf", "bf", "wa", "ba", "wb", "bb", "wc", "bc"]


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
    weights = [f(FIN, L1, sc=0.3), f(L1, sc=0.1), f(L1, D, sc=0.3), f(D, sc=0.1),
               f(L1, D, sc=0.3), f(D, sc=0.1), f(D, sc=0.3), np.float32(0.05)]
    h = f(B, N, FIN)
    mask = np.arange(N)[None, :] < np.array([16, 10, 5, 16])[:, None]
    perm = rng.permutation(B)
    lam = (0.9 + rng.random(B) * 0.1).astype(np.float32)
    cots = [f(B, L1), f(B, N), f(B, N)]
    return h, weights, mask, perm, lam, cots


def _jax_run(h, weights, mask, mix, cots, impl, dtype):
    def run(ws):
        def fwd(*w):
            return gap.fused_trunk_attention_pool(
                jnp.asarray(h, dtype), *w, mask=jnp.asarray(mask), impl=impl,
                input_grad=False, mix=mix)

        outs, vjp = jax.vjp(fwd, *ws)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    ws = [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    outs, grads = compiled(ws)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_run(h, weights, mask, mix, cots, dtype):
    w = [torch.tensor(x, requires_grad=True) for x in weights]
    outs = tat.fused_trunk_attention_pool(
        torch.tensor(h).to(dtype), *w, mask=torch.tensor(mask), mix=mix)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    return [o.detach().numpy() for o in outs], [x.grad.numpy() for x in w]


@pytest.mark.parametrize("use_mix", [False, True])
def test_plain_matches_xla_golden_f32(use_mix):
    h, weights, mask, perm, lam, cots = _inputs(0)
    jmix = (jnp.asarray(perm, jnp.int32), jnp.asarray(lam)) if use_mix else None
    tmix = (torch.tensor(perm), torch.tensor(lam)) if use_mix else None
    want, gwant = _jax_run(h, weights, mask, jmix, cots, "xla", jnp.float32)
    got, ggot = _torch_run(h, weights, mask, tmix, cots, torch.float32)
    for name, w, g in zip("Mps", want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    for name, w, g in zip(NAMES, gwant, ggot):
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_plain_matches_pallas_interpret_bf16(interpret_pallas):
    h, weights, mask, perm, lam, cots = _inputs(1)
    jmix = (jnp.asarray(perm, jnp.int32), jnp.asarray(lam))
    tmix = (torch.tensor(perm), torch.tensor(lam))
    want, gwant = _jax_run(h, weights, mask, jmix, cots, "pallas", jnp.bfloat16)
    got, ggot = _torch_run(h, weights, mask, tmix, cots, torch.bfloat16)
    for name, w, g in zip(["M", "p", "s"] + NAMES, want + gwant, got + ggot):
        assert _rel(g.reshape(np.shape(w)), w) <= 1e-5, name


def _fmix32_ref(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_dropout_bits_match_32bit_definition():
    seed, rows, cols = 2**31 - 5, 3, 7
    bits = tat._keep_bits(seed, torch.arange(3), rows, cols, 2)
    for bag in range(3):
        key = _fmix32_ref(seed ^ (((bag * 4 + 2 + 1) * 0x9E3779B1) & 0xFFFFFFFF))
        for r in range(rows):
            for c in range(cols):
                idx = ((r * cols + c) * 0x7FEB352D) & 0xFFFFFFFF
                assert int(bits[bag, r, c]) == _fmix32_ref(key ^ idx)


def test_dropout_deterministic_with_keep_rate():
    h, weights, mask, _, _, _ = _inputs(2)
    th = torch.tensor(h)
    w = [torch.tensor(x) for x in weights]
    m = torch.tensor(mask)
    a = tat.fused_trunk_attention_pool(th, *w, mask=m, dropout=0.25, seed=7)
    b = tat.fused_trunk_attention_pool(th, *w, mask=m, dropout=0.25, seed=7)
    c = tat.fused_trunk_attention_pool(th, *w, mask=m, dropout=0.25, seed=8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    keep = tat._keep_bits(123, torch.arange(64), 128, 128, 0) >= tat.dropout_threshold(0.25)
    assert abs(keep.float().mean().item() - 0.75) < 0.0075


def test_bags_requiring_grad_are_refused():
    # with mix only: the unmixed op returns dh (tests/test_torch_fused_modes.py)
    h, weights, mask, perm, lam, _ = _inputs(3)
    with pytest.raises(ValueError, match="no gradient for the bags"):
        tat.fused_trunk_attention_pool(torch.tensor(h, requires_grad=True),
                                       *[torch.tensor(x) for x in weights],
                                       mix=(torch.tensor(perm), torch.tensor(lam)))
