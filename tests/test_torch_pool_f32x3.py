"""K7's float32 route, as arithmetic on the CPU, against the JAX package.

On the card the f32 route of the attention pool (``csrc/attention_pool.cu``
with T = float) takes every f32 product as three bf16 products of the
operands' planes (:func:`split_bf16`: ``hi hi + hi lo + lo hi``, summed in
f32): the gate products ``x @ Wa`` and ``x @ Wb`` from x's planes
(``split_kernel``) and W's (``_w_planes_cuda``), dx's products from the
dz scratch's planes and W's, and dWa = ``x^T @ dza`` from x's planes and the
scratch's. The gates, scores, softmax, ``M = p @ x`` and the bias
gradients stay f32 (dba and dbb sum the f32 dz, not their planes).
``_x3_fwd`` and ``_x3_bwd`` take the same products in the kernels' order of
operations, in plain torch, and are held against the JAX package's f32
K7f/K7b (``_fwd_pallas`` / ``_bwd_pallas`` in interpret mode, as
``tests/test_torch_pool.py`` runs them) on the same numpy-seeded weights and
bags: M, p, s, dx and the six weight gradients to a relative Frobenius error
of 1e-4, the tolerance ``chip_smoke.py`` holds the f32 kernels to. Gated and
ungated, D 128 and 256 at F 512, bags of 200-300 rows with masked tails
that end inside a 128-row tile, dropout 0 (the TPU draws its masks from its
own PRNG). A single bf16 product per f32 product misses 1e-4 on dx and dWa
(``test_one_bf16_product_misses``), which is why the kernels take three.
The kernels themselves are held against the plain twins on the card
(``tests/test_torch_cuda.py -k attention_pool``, ``chip_smoke.py``
``check_pool_f32``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops.attention import split_bf16

B, F = 3, 512
NAMES = ["dx", "wa", "ba", "wb", "bb", "wc", "bc"]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


def _mm3(a, b):
    """``a @ b`` as the f32 route's products take it: three bf16 products of
    the operands' planes, summed in f32."""
    ah, al = (t.float() for t in split_bf16(a))
    bh, bl = (t.float() for t in split_bf16(b))
    return ah @ bh + ah @ bl + al @ bh


def _mm1(a, b):
    """``a @ b`` as one bf16 product of the operands' hi planes."""
    return split_bf16(a)[0].float() @ split_bf16(b)[0].float()


def _gates(x, w, gated, mm):
    wa, ba, wb, bb = w[:4]
    a = torch.tanh(mm(x, wa) + ba)
    g = torch.sigmoid(mm(x, wb) + bb) if gated else None
    return a, g


def _x3_fwd(x, w, mask, gated):
    a, g = _gates(x, w, gated, _mm3)
    u = a * g if gated else a
    s = u @ w[4] + w[5]  # the epilogue's f32 sum per row
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    m = torch.einsum("bn,bnf->bf", p, x)  # pool_kernel over the f32 bag
    return m, p, s


def _x3_bwd(x, w, mask, p, cots, gated, mm=_mm3):
    wa, wb, wc = w[0], w[2], w[4]
    gm, gp, gs = cots
    a, g = _gates(x, w, gated, mm)
    u = a * g if gated else a
    dp = (x * gm[:, None, :]).sum(-1) + gp  # dp_kernel over the f32 bag
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) + gs
    dbc, dwc = ds.sum(), torch.einsum("bnd,bn->d", u, ds)
    du = ds[..., None] * wc
    dza = (du * g if gated else du) * (1 - a * a)
    acc = mm(dza, wa.T)  # dx's products: the scratch's planes against W's
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dwa, dba = mm(flat(x).T, flat(dza)), flat(dza).sum(0)
    if gated:
        dzb = du * a * g * (1 - g)
        acc = acc + mm(dzb, wb.T)  # gate b's into the same accumulator
        dwb, dbb = mm(flat(x).T, flat(dzb)), flat(dzb).sum(0)
    else:
        dwb, dbb = torch.zeros_like(dwa), torch.zeros_like(dba)
    dx = p[..., None] * gm[:, None, :] + acc
    return [dx, dwa, dba, dwb, dbb, dwc, dbc]


def _inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    weights = [f(F, d, sc=F ** -0.5), f(d, sc=0.1), f(F, d, sc=F ** -0.5), f(d, sc=0.1),
               f(d, sc=d ** -0.5), np.float32(0.1)]
    x = np.maximum(f(B, n, F), 0)  # a trunk output: post-relu
    mask = np.arange(n)[None, :] < np.array([n, n - 77, 129])[:, None]
    # s's cotangent with a mean of 0.01, as in test_torch_trunk_f32x3.py: dbc
    # sums it with terms that cancel within each bag
    cots = [f(B, F), f(B, n, sc=0.1), f(B, n, sc=0.01) + np.float32(0.01)]
    return x, weights, mask, cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_run(x, weights, mask, cots, gated):
    def fwd(xx, *w):
        return gap.gated_attention_pool(xx, *w, mask=jnp.asarray(mask), impl="pallas",
                                        gated=gated)

    def run(xx, ws):
        outs, vjp = jax.vjp(fwd, xx, *ws)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    xx, ws = jnp.asarray(x), [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(xx, ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    outs, grads = compiled(xx, ws)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_inputs(x, weights, mask, cots):
    return (torch.tensor(x), [torch.tensor(v) for v in weights], torch.tensor(mask),
            [torch.tensor(c) for c in cots])


@pytest.mark.parametrize("gated,d,n", [
    (True, 256, 264),   # supervised CLAM_SB: gated, D 256
    (False, 128, 200),  # ABMIL's mode: ungated, D 128
    (True, 128, 300),
    (False, 256, 232),
])
def test_three_bf16_products_match_jax_f32(interpret_pallas, gated, d, n):
    x, weights, mask, cots = _inputs(5, n, d)
    want, gwant = _jax_run(x, weights, mask, cots, gated)
    xt, wt, mt, ct = _torch_inputs(x, weights, mask, cots)
    got = _x3_fwd(xt, wt, mt, gated)
    ggot = _x3_bwd(xt, wt, mt, got[1], ct, gated)
    for name, g, w in zip("Mps", got, want):
        assert _rel(g, w) <= 1e-4, name
    for name, g, w in zip(NAMES, ggot, gwant):
        if not gated and name in ("wb", "bb"):
            assert not g.any(), name  # inert inputs of the ungated pool
            continue
        assert _rel(g.reshape(np.shape(w)), w) <= 1e-4, name


def test_one_bf16_product_misses(interpret_pallas):
    # the planes are what makes the tolerance: with one bf16 product per f32
    # product (the hi planes alone), dx and dWa miss 1e-4 where three hold it
    x, weights, mask, cots = _inputs(6, 264, 256)
    _, gwant = _jax_run(x, weights, mask, cots, True)
    xt, wt, mt, ct = _torch_inputs(x, weights, mask, cots)
    p = _x3_fwd(xt, wt, mt, True)[1]
    three = _x3_bwd(xt, wt, mt, p, ct, True)
    one = _x3_bwd(xt, wt, mt, p, ct, True, mm=_mm1)
    for k in (0, 1):  # dx, dWa
        assert _rel(three[k].reshape(np.shape(gwant[k])), gwant[k]) <= 1e-5, NAMES[k]
        assert _rel(one[k].reshape(np.shape(gwant[k])), gwant[k]) > 1e-4, NAMES[k]
